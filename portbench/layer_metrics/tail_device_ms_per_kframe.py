"""``tail_device_ms_per_kframe``: device time of every kernel that is not
K1's (the one-pass tail ``_finalize``, detection, AoA, association, the
solve, the pose) per 1,000 radar frames of the traced window (ms)."""

import importlib.util
from pathlib import Path


def _k1():
    path = Path(__file__).with_name("k1_roofline.py")
    spec = importlib.util.spec_from_file_location("k1_roofline_names", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(rec):
    is_k1 = _k1().is_k1
    t = sum(e.end - e.start for e in rec.events
            if e.kind == "kernel" and not is_k1(e))
    if rec.frames <= 0 or t <= 0:
        return None
    return t * 1e3 / (rec.frames / 1e3)
