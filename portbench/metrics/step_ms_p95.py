"""step_ms_p95: the 95th percentile of every step's host-clock time in the
window, from the call to the return of its synchronise."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.step_seconds(), 95)) * 1e3
