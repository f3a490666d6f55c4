"""``latency_ms_p95``: the 95th percentile of the host time of every step
in the window, from handing the frame over to the return (ms)."""

import numpy as np


def read(win):
    return float(np.percentile([e - s for s, e in win["spans"]], 95) * 1e3)
