"""``k1_roofline``: K1's share of its roofline (%) over the traced window --
the least time the card could take for K1's work on the frames traced
(``work/k1.py``: published H100 SXM peaks, work from the shapes and the
frame count alone) over the device time of K1's kernels.  The card's
power limit stands beside the number in PERF.md."""

from portbench.trace import parameter_types
from portbench.work import k1

# K1's kernels in csrc/frontend.cu (the range FFT of the fast-time
# factors, the product / Doppler power, the CFAR mask, its prefix-sum and
# time-domain variants), each by its name and the type of its first
# parameter: csrc/cube.cu's K10 is a ``cfar_kernel`` too, over an RDS of
# float2.
KERNELS = {"range_fft_kernel": "Factors", "z_power_kernel": "Factors",
           "cfar_kernel": "float*", "cfar_cumsum_kernel": "float*",
           "compose_efast_kernel": "Factors"}


def is_k1(event) -> bool:
    first = KERNELS.get(event.name.split("<")[0])
    params = parameter_types(event.full)
    return first is not None and bool(params) and params[0] == first


def read(rec):
    t = sum(e.end - e.start for e in rec.events
            if e.kind == "kernel" and is_k1(e))
    if t <= 0 or rec.k1_frames <= 0:
        return None
    w = k1.work(rec.info["config"]["pipeline"], rec.k1_frames)
    return 100.0 * k1.least_time_s(w) / t
