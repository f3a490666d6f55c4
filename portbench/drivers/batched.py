"""Batch reprocessing of recorded drives: ``process_sequence_batched``.

Closed loop, one client, calls back to back (``common.SampledCalls``): a
pool of ``pool`` sequences of ``frames`` frames of the configuration's
scene, each with its own world drawn from the seed.
"""

from __future__ import annotations

from portbench import common
from portbench.reference import pipeline as ref


class Driver(common.SampledCalls):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        from radar_slam_tpu_torch.pipeline.frame import \
            process_sequence_batched
        self._run = process_sequence_batched
        self.F = int(cell.mix["frames"])
        self.unit_frames = self.unit_k1_frames = self.F
        self.cols, _ = self.make_inputs(self.F)
        self.pool = [common.program_batch(c, device) for c in self.cols]

    def _call(self, batch, gen_seed: int):
        import torch
        return self._run(batch, torch.Generator().manual_seed(gen_seed),
                         self.cfg)

    def _reference(self, i: int, precision: str):
        return ref.batched(
            common.reference_batch(self.cols[i % len(self.cols)],
                                   self.device),
            common.noise_seeds(self.noise_seed(i), self.F, self.device),
            common.reference_cfg(self.cell), precision)
