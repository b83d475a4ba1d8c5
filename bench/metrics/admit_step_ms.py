"""admit_step_ms (ms, program_span): the median host wall of the window's
engine steps that admitted at least one request (prefill, install burst
and the decode), over the steps outside the profiled slice when there are
any."""

import numpy as np


def read(run):
    steps = [s for s in run.steps if s.admitted]
    plain = [s for s in steps if not s.profiled] or steps
    if not plain:
        return None
    return float(np.median([s.end - s.start for s in plain])) * 1e3
