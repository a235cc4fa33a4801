"""The 95th percentile of every request's latency in the window, in ms:
from issue until the host array is in hand. Read in the traced run, whose
first ``TRACE_SECONDS`` of requests also carry the profiler's spans."""

import numpy as np


def read(run):
    return float(np.percentile([d.t1 - d.t0 for d in run.done], 95)) * 1e3
