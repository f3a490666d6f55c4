"""``analyze --dataset`` on a RadarScenes recording: the double-buffered
rig ingest, ``process_sequence_rig_batched_prefetch``.

Closed loop, one client (``common.SampledCalls``): a pool of ``pool``
recordings of ``rig_frames`` rig frames (the configuration's mounted
radars) as the loader's host arrays; each call ingests one from the host
at the driver's chunk of ``chunk`` rig frames.  A rig frame is one radar
frame per sensor.
"""

from __future__ import annotations

from portbench import common
from portbench.reference import pipeline as ref


class Driver(common.SampledCalls):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        from radar_slam_tpu_torch.io.prefetch import \
            process_sequence_rig_batched_prefetch
        self._run = process_sequence_rig_batched_prefetch
        self.F = int(cell.mix["rig_frames"])
        self.chunk = int(cell.mix["chunk"])
        self.cols, self.rig = self.make_inputs(self.F)
        self.B = len(self.rig)
        self.unit_frames = self.unit_k1_frames = self.F * self.B
        self.pool = [common.host_batch(c) for c in self.cols]

    def _call(self, host, gen_seed: int):
        import torch
        return self._run(host, torch.Generator().manual_seed(gen_seed),
                         self.cfg, self.rig, chunk=self.chunk,
                         device=self.device)

    def _reference(self, i: int, precision: str):
        seeds = common.noise_seeds(self.noise_seed(i), self.F * self.B,
                                   self.device).reshape(self.F, self.B)
        return ref.rig_batched(
            common.reference_batch(self.cols[i % len(self.cols)],
                                   self.device),
            seeds, common.reference_cfg(self.cell), self.rig, precision)
