"""tpot_p95_ms (ms, host clock): the 95th percentile of every gap between
consecutive tokens of every request, over the gaps that end in the window.
A step that admits and prefills shows as a long gap for every other live
request; the two tokens of an admitting step (the prefill's and the
decode's) arrive together, a gap of 0."""

import numpy as np


def read(run):
    t0, t1 = run.window_start, run.window_start + run.window_s
    gaps = [b - a for r in run.requests
            for a, b in zip(r.times, r.times[1:]) if t0 <= b <= t1]
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
