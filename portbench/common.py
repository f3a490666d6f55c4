"""What every driver shares: seeds, inputs on the device, the configuration
on both sides, and the host record of a unit's outputs.

A driver (``drivers/<name>.py``) defines ``Driver(cell, seed, device)``
with:

- ``unit_frames`` / ``unit_k1_frames``: radar frames one unit (a call or a
  step) completes, and frames it runs through the front-end kernel;
- ``warm()``: one unit of every shape the window uses (set-up);
- ``prepare(i)``: untimed work before unit ``i``;
- ``step(i) -> int``: unit ``i``, its outputs on the host; returns the
  number of frames that failed (a raise or a non-finite pose);
- ``release()``: drops the program's state before the reference runs;
- ``expected(i, precision) -> Sample``: the reference's outputs of the
  sampled unit ``i`` at ``precision`` ("float64", or the control's
  "tf32");
- ``compare(precision)``: the numbers of the sampled units' outputs
  against ``expected`` (:mod:`portbench.compare`), each the largest over
  the sampled units.

:class:`SampledCalls` is the base of the drivers whose unit is a call over
a whole sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from portbench import compare as cmp
from portbench.reference.core.config import \
    config_from_dict as reference_config
from portbench.reference.core.types import ScattererBatch as RefBatch

FIELDS = ("range_m", "azimuth_rad", "rcs_db", "vr", "valid")


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed drawn from the run's seed and ``keys``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *keys])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def program_config(cell):
    from radar_slam_tpu_torch.core.config import config_from_dict
    return config_from_dict(cell.config["pipeline"])


def program_batch(cols: Dict[str, np.ndarray], device):
    """The program's ``ScattererBatch`` on ``device`` from numpy columns."""
    from radar_slam_tpu_torch.core.types import ScattererBatch
    return ScattererBatch(*[torch.from_numpy(np.ascontiguousarray(cols[k]))
                            .to(device) for k in FIELDS])


def host_batch(cols: Dict[str, np.ndarray]):
    """The program's ``ScattererBatch`` of numpy leaves (host-resident)."""
    from radar_slam_tpu_torch.core.types import ScattererBatch
    return ScattererBatch(*[np.ascontiguousarray(cols[k]) for k in FIELDS])


def reference_batch(cols: Dict[str, np.ndarray], device) -> RefBatch:
    return RefBatch(*[torch.from_numpy(np.ascontiguousarray(cols[k]))
                      .to(device) for k in FIELDS])


def reference_cfg(cell):
    return reference_config(cell.config["pipeline"])


def noise_seeds(gen_seed: int, n: int, device) -> torch.Tensor:
    """The frame seeds [n] a driver draws from a fresh generator seeded
    ``gen_seed`` (the frozen ``ops/noise.py:frame_seeds``)."""
    from portbench.reference.ops.noise import frame_seeds
    return frame_seeds(torch.Generator().manual_seed(gen_seed), n, device)


def frame_numbers(out) -> torch.Tensor:
    """One row per frame of what a batched call hands the host: pose (3),
    velocity (3), angular velocity (3), success, detections, reliable
    targets, associations."""
    m = out.motion
    return torch.cat([out.pose, m.velocity, m.angular_velocity,
                      torch.stack([m.success.to(torch.float32),
                                   out.num_detections.to(torch.float32),
                                   out.num_reliable.to(torch.float32),
                                   out.num_associations.to(torch.float32)],
                                  dim=-1)], dim=-1)


@dataclasses.dataclass
class Sample:
    """A sampled unit's outputs on the host, kept for the comparison."""
    rows: np.ndarray                 # [F, 13] (frame_numbers' columns)
    target_xy: np.ndarray = None     # [F, K, 2]
    target_valid: np.ndarray = None  # [F, K]


def fetch(out) -> Sample:
    """A sampled call's outputs (left on the device in the window), on the
    host."""
    out, rows = out
    return Sample(rows.numpy(), out.target_xy.cpu().numpy(),
                  out.target_valid.cpu().numpy())


class Driver:
    """Sampled units and their comparison; ``kept`` maps a sampled unit's
    index to its :class:`Sample` once ``release`` has run."""

    counts = {"detections": 10, "reliable": 11, "associations": 12}
    kept: Dict[int, Sample]

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = program_config(cell)
        self.kept = {}

    def make_inputs(self, frames: int):
        """The pool's numpy columns and the rig (None for one sensor)."""
        made = [self.cell.scene.make(self.cell.config["scene"], frames,
                                     sub_seed(self.seed, 1, p),
                                     self.cfg.max_scatterers,
                                     self.cfg.frame_dt)
                for p in range(int(self.cell.mix["pool"]))]
        return [c for c, _ in made], made[0][1]

    def expected(self, i: int, precision: str) -> Sample:
        raise NotImplementedError

    def compare(self, precision: str = "float64"):
        readings: Dict[str, float] = {}
        for i, got in sorted(self.kept.items()):
            numbers = cmp.numbers_of(got, self.expected(i, precision),
                                     self.counts)
            for k, v in numbers.items():
                readings[k] = max(readings.get(k, v), v)
        return readings, self.compared()

    def compared(self) -> Dict:
        return {"compared_units": sorted(self.kept),
                "compared_frames": sum(s.rows.shape[0]
                                       for s in self.kept.values())}


class SampledCalls(Driver):
    """A closed loop of calls over whole sequences from a pool made at
    set-up; call ``i`` takes sequence ``i % pool`` and a fresh noise
    generator seeded from the run's seed and ``i``, and fetches every
    frame's pose, motion and counts to the host in one copy.  The sampled
    calls (``check_calls`` of the first ``check_among``, drawn from the
    seed) keep their outputs for the comparison.  Subclasses set
    ``unit_frames``, ``unit_k1_frames`` and ``pool`` and define
    ``_call(inputs, gen_seed)`` and ``_reference(i, precision)``."""

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        rng = np.random.default_rng(sub_seed(seed, 2))
        self.sampled = set(rng.choice(int(cell.mix["check_among"]),
                                      int(cell.mix["check_calls"]),
                                      replace=False).tolist())

    def noise_seed(self, i: int) -> int:
        return sub_seed(self.seed, 3, i)

    def warm(self):
        frame_numbers(self._call(self.pool[0], 0)).cpu()

    def prepare(self, i: int):
        pass

    def step(self, i: int) -> int:
        out = self._call(self.pool[i % len(self.pool)], self.noise_seed(i))
        rows = frame_numbers(out).cpu()
        if i in self.sampled:
            self.kept[i] = (out, rows)
        return (0 if bool(torch.isfinite(rows[:, :3]).all())
                else self.unit_frames)

    def release(self):
        self.kept = {i: fetch(v) for i, v in self.kept.items()}
        self.pool = None

    def expected(self, i: int, precision: str) -> Sample:
        with torch.no_grad():
            return Sample(*self._reference(i, precision))
