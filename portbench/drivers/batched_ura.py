"""Batch reprocessing of drives recorded with a 3-D imaging radar (a planar
array, URA): ``process_sequence_batched`` on scatterers with elevations.

Closed loop, one client, calls back to back (``common.SampledCalls``): a
pool of ``pool`` sequences of ``frames`` frames of the configuration's 3-D
scene, each with its own world drawn from the seed; the scatterers carry
``elevation_rad``.  The sampled calls keep the targets' heights
(``FrameOutput.target_z``) besides the batched numbers, and the
comparison adds ``heights_off``: the share of target slots, valid on
either side, that are valid on one side only or whose heights lie more
than ``Z_TOL`` apart.  A program that reports no heights cannot be held
to the configuration, and the run stops at set-up (exit 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import common
from portbench import compare as cmp
from portbench.reference import pipeline_3d as ref
from portbench.reference.core.types import ScattererBatch as RefBatch

FIELDS = common.FIELDS + ("elevation_rad",)
Z_TOL = cmp.XY_TOL    # m


@dataclasses.dataclass
class Sample3D(common.Sample):
    target_z: np.ndarray = None      # [F, K]


def heights_off(got: Sample3D, want: Sample3D) -> float:
    either = got.target_valid | want.target_valid
    off = ((got.target_valid != want.target_valid)
           | ~(np.abs(got.target_z - want.target_z) <= Z_TOL))
    return float(np.mean(off[either])) if either.any() else 0.0


class Driver(common.SampledCalls):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        from radar_slam_tpu_torch.core.types import FrameOutput
        from radar_slam_tpu_torch.pipeline.frame import \
            process_sequence_batched
        if "target_z" not in FrameOutput._fields:
            raise KeyError("the program's FrameOutput has no target_z: "
                           "no target heights to compare")
        self._run = process_sequence_batched
        self.F = int(cell.mix["frames"])
        self.unit_frames = self.unit_k1_frames = self.F
        self.cols, _ = self.make_inputs(self.F)
        self.pool = [self._batch(c, device) for c in self.cols]

    @staticmethod
    def _batch(cols, device):
        from radar_slam_tpu_torch.core.types import ScattererBatch
        return ScattererBatch(**{k: torch.from_numpy(
            np.ascontiguousarray(cols[k])).to(device) for k in FIELDS})

    def _call(self, batch, gen_seed: int):
        return self._run(batch, torch.Generator().manual_seed(gen_seed),
                         self.cfg)

    def release(self):
        self.kept = {i: Sample3D(rows.numpy(), out.target_xy.cpu().numpy(),
                                 out.target_valid.cpu().numpy(),
                                 out.target_z.cpu().numpy())
                     for i, (out, rows) in self.kept.items()}
        self.pool = None

    def _reference(self, i: int, precision: str):
        cols = self.cols[i % len(self.cols)]
        return ref.batched_3d(
            RefBatch(**{k: torch.from_numpy(np.ascontiguousarray(cols[k]))
                        .to(self.device) for k in FIELDS}),
            common.noise_seeds(self.noise_seed(i), self.F, self.device),
            common.reference_cfg(self.cell), precision)

    def expected(self, i: int, precision: str) -> Sample3D:
        with torch.no_grad():
            return Sample3D(*self._reference(i, precision))

    def numbers_of(self, got: Sample3D, want: Sample3D):
        """``compare.numbers_of`` and ``heights_off``."""
        return {**cmp.numbers_of(got, want, self.counts),
                "heights_off": heights_off(got, want)}

    def compare(self, precision: str = "float64"):
        readings = {}
        for i, got in sorted(self.kept.items()):
            for k, v in self.numbers_of(
                    got, self.expected(i, precision)).items():
                readings[k] = max(readings.get(k, v), v)
        return readings, self.compared()
