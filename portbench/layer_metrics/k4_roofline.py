"""``k4_roofline``: K4's share of its roofline (%) over the traced window --
the least time the card could take for K4's work on the frames traced
(``work/three_dispatch.py``: published H100 SXM peaks, work from the
shapes and the frame count alone) over the device time of K4's kernels.

K4's kernels (``csrc/synthpower.cu:synth_power``) are the on-chip cube
kernel on the dense factors with the power consumer,
``cube_onchip_kernel<1, IMPL, 1>`` (``csrc/cube_onchip.cuh``: SRC_DENSE,
OUT_PSC), and the ``antenna_sum_kernel`` launched after it; K5's
(``synth_signatures``) the same kernel with the signature consumer,
``cube_onchip_kernel<1, IMPL, 2>`` (OUT_SIG), and the
``sig_normalize_kernel`` after it.  Each is known by its name, its
template arguments and its parameter types; the second launches by
the on-chip kernel before them, since K7 and K1's time domain launch an
``antenna_sum_kernel`` too."""

import re

from portbench.trace import parameter_types
from portbench.work import three_dispatch

ONCHIP = re.compile(
    r"^cube_onchip_kernel<\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*>$")
SRC_DENSE, OUT_PSC, OUT_SIG = 1, 1, 2
SECOND = {"antenna_sum_kernel": ("k4", ["float*", "float*", "int", "int",
                                        "float"]),
          "sig_normalize_kernel": ("k5", ["float2*", "int", "int"])}


def owners(events):
    """[(event, "k4", "k5" or None)] of the traced kernels in start order."""
    out, last = [], None
    for e in sorted((e for e in events if e.kind == "kernel"),
                    key=lambda e: e.start):
        m = ONCHIP.match(e.name)
        who = None
        if m and parameter_types(e.full) == ["OcArgs"]:
            src, dst = int(m.group(1)), int(m.group(3))
            last = who = ({OUT_PSC: "k4", OUT_SIG: "k5"}.get(dst)
                          if src == SRC_DENSE else None)
        elif e.name in SECOND:
            kernel, params = SECOND[e.name]
            if last == kernel and parameter_types(e.full) == params:
                who = kernel
        out.append((e, who))
    return out


def roofline(rec, kernel, work):
    t = sum(e.end - e.start for e, who in owners(rec.events)
            if who == kernel)
    if t <= 0 or rec.frames <= 0:
        return None
    w = work(rec.info["config"]["pipeline"], rec.frames)
    return 100.0 * three_dispatch.least_time_s(w) / t


def read(rec):
    return roofline(rec, "k4", three_dispatch.k4_work)
