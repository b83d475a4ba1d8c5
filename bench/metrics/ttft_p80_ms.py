"""ttft_p80_ms (ms, host clock): the 80th percentile, over the requests
whose first token came in the window, of the time from the client sending
the request to that token.  A window of ``repo_complete`` sees some fifty
first tokens, so the 80th is the highest percentile with ten beyond it."""

import numpy as np


def read(run):
    t0, t1 = run.window_start, run.window_start + run.window_s
    ttft = [r.times[0] - r.sent for r in run.requests
            if r.times and t0 <= r.times[0] <= t1]
    if not ttft:
        return None
    return float(np.percentile(ttft, 80)) * 1e3
