"""The real-time user: ``StreamingAnalyzer.process_frame``, one frame a
step with the tracker's state carried over.

Closed loop, one stream.  Set-up makes a pool of ``pool`` host-resident
sequences of ``episode_frames`` frames from the seed (the configuration's
scene, each with its own world).  Step ``i`` hands frame ``i %
episode_frames`` of sequence ``(i // episode_frames) % pool``, as host
arrays, to the analyzer and returns when ``process_frame`` does (its one
host fetch included); when a sequence runs out, a new analyzer starts,
untimed.  The first ``check_steps`` steps of the first sequence are
compared, replayed by the reference from the same initial state.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import common
from portbench.reference import pipeline as ref


class Driver(common.Driver):
    counts = {"reliable": 10, "associations": 11}

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        from radar_slam_tpu_torch.pipeline.streaming import StreamingAnalyzer
        self._analyzer = StreamingAnalyzer
        self.L = int(cell.mix["episode_frames"])
        self.warm_steps = int(cell.mix["warm_steps"])
        self.check_steps = int(cell.mix["check_steps"])
        self.unit_frames = self.unit_k1_frames = 1
        self.cols, _ = self.make_inputs(self.L)
        self.analyzer = None
        self.first = None          # the compared episode's analyzer

    def _frame(self, cols, j: int):
        return common.program_batch({k: v[j:j + 1] for k, v in cols.items()},
                                    self.device)

    def warm(self):
        a = self._analyzer(self.cfg, device=self.device)
        for j in range(self.warm_steps):
            a.process_frame(self._frame(self.cols[0], j))

    def prepare(self, i: int):
        if i % self.L == 0:
            self.analyzer = self._analyzer(self.cfg, device=self.device)
            if self.first is None:
                self.first = self.analyzer

    def step(self, i: int) -> int:
        cols = self.cols[(i // self.L) % len(self.cols)]
        r = self.analyzer.process_frame(self._frame(cols, i % self.L))
        return 0 if bool(np.isfinite(r["pose"]).all()) else 1

    def release(self):
        self.analyzer = None
        if self.first is not None:
            rows = self.program_rows()[:self.check_steps]
            self.kept = {0: common.Sample(rows)}
            self.first = None

    def program_rows(self) -> np.ndarray:
        r = self.first.results
        return np.concatenate([
            np.asarray(r["estimated_trajectory"], np.float32).reshape(-1, 3),
            np.asarray(r["velocity_estimates"], np.float32).reshape(-1, 6),
            np.stack([np.asarray(r["success"], np.float32),
                      np.asarray(r["num_targets"], np.float32),
                      np.asarray(r["num_associations"], np.float32)],
                     axis=-1)], axis=-1)

    def expected(self, i: int, precision: str) -> common.Sample:
        n = self.kept[i].rows.shape[0]
        cols = {k: v[:n] for k, v in self.cols[i].items()}
        with torch.no_grad():
            return common.Sample(ref.stream(
                common.reference_batch(cols, self.device),
                common.reference_cfg(self.cell), precision).rows)
