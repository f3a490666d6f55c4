"""Batch reprocessing of drives at the reference's fidelity with OS-CFAR:
``process_sequence_batched`` on its three-dispatch route (K4's power map,
the detection, K5's signatures).

The closed loop of ``drivers/batched.py`` (calls back to back, a pool of
``pool`` sequences of ``frames`` frames, each world drawn from the seed,
fresh noise a call), held to the plain reference of the three-dispatch
route (``reference/pipeline_three_dispatch.py``).  No frame runs through
K1 (``unit_k1_frames`` 0).

The cell measures that route, so the warm call must show it: the order
statistic's counter (``signal/detect.py:_os_noise.calls``) once, and on
the card K4 and K5 launched once each and K1 never (the wrappers'
``.launches``).  A program that does not count its order statistic
cannot show the route, and the run stops at set-up (exit 3).
"""

from __future__ import annotations

from portbench import common
from portbench.drivers import batched
from portbench.reference import pipeline_three_dispatch as ref


def _launches():
    """(K4, K5, K1) launches so far, and the order statistic's calls."""
    from radar_slam_tpu_torch.ops import frontend, synthpower
    from radar_slam_tpu_torch.signal import detect
    return (synthpower.scatterer_power.launches,
            synthpower.scatterer_signatures.launches,
            frontend.frontend_kernel_split.launches
            + frontend.frontend_kernel_dense.launches,
            detect._os_noise.calls)


class Driver(batched.Driver):
    def __init__(self, cell, seed: int, device):
        from radar_slam_tpu_torch.signal import detect
        if not hasattr(detect._os_noise, "calls"):
            raise KeyError("the program does not count its order "
                           "statistic (_os_noise.calls): the three-dispatch "
                           "route cannot be shown")
        super().__init__(cell, seed, device)
        self.unit_k1_frames = 0

    def warm(self):
        before = _launches()
        super().warm()
        k4, k5, k1, os_calls = (b - a for a, b in zip(before, _launches()))
        card = self.device.type == "cuda"
        want_os = int(self.cfg.detection.cfar_mode == "os")
        if (os_calls, k1) != (want_os, 0) or (
                card and (k4, k5) != (1, 1)):
            raise RuntimeError(
                f"a call is not on the three-dispatch route: K4 {k4}, K5 "
                f"{k5}, K1 {k1} launches, {os_calls} order statistics")

    def _reference(self, i: int, precision: str):
        return ref.batched(
            common.reference_batch(self.cols[i % len(self.cols)],
                                   self.device),
            common.noise_seeds(self.noise_seed(i), self.F, self.device),
            common.reference_cfg(self.cell), precision)
