"""``k5_roofline``: K5's share of its roofline (%) over the traced window --
the least time of K5's work on the frames traced
(``work/three_dispatch.py``: the cube's synthesis, the F*K column
products and the normalization) over the device time of K5's kernels,
found as ``k4_roofline.py`` finds them."""

import importlib.util
from pathlib import Path

from portbench.work import three_dispatch


def _k4():
    path = Path(__file__).with_name("k4_roofline.py")
    spec = importlib.util.spec_from_file_location("k4_roofline_names", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(rec):
    return _k4().roofline(rec, "k5", three_dispatch.k5_work)
