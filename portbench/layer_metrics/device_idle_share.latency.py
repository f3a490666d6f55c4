"""``device_idle_share.latency``: 1 - the union of the device's intervals
(kernels and copies) over the host wall of the traced steps, from a
CUDA-only trace (``trace.idle_share``); it moves ``latency_ms_p95``."""

from portbench.trace import idle_share


def read(rec):
    return idle_share(rec) if rec.events else None
