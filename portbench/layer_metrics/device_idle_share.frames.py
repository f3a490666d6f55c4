"""``device_idle_share.frames``: 1 - the union of the device's intervals
(kernels and copies) over the host wall of the traced calls, from a
CUDA-only trace (``trace.idle_share``); it moves ``frames_per_s``."""

from portbench.trace import idle_share


def read(rec):
    return idle_share(rec) if rec.events else None
