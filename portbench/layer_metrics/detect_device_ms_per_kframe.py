"""``detect_device_ms_per_kframe``: the device time of the kernels that run
between a call's last K4 kernel and its first K5 kernel -- the detection
on K4's power map: the OS-CFAR order statistic, the peak mask, the range
gate and the top-K -- per 1,000 radar frames of the traced window (ms).
K4's and K5's kernels are found as ``k4_roofline.py`` finds them; the
kernels between need no names."""

import importlib.util
from pathlib import Path


def _k4():
    path = Path(__file__).with_name("k4_roofline.py")
    spec = importlib.util.spec_from_file_location("k4_roofline_names", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(rec):
    total, pending, calls = 0.0, None, 0
    for e, who in _k4().owners(rec.events):
        if who == "k4":
            pending = 0.0
        elif who == "k5":
            if pending is not None:
                total += pending
                calls += 1
            pending = None
        elif pending is not None:
            pending += e.end - e.start
    if calls == 0 or rec.frames <= 0:
        return None
    return total * 1e3 / (rec.frames / 1e3)
