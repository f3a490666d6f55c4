"""Six-step artifact pipeline over a frame sequence.

Counterpart of ``radar_slam_tpu/pipeline/pipeline.py`` (``EgoMotionPipeline``;
the reference's ``run_ego_motion_pipeline.py:51-446``):

1. synthesize raw signals       ``step1_synthesize``
2. RDS + peak extraction        ``step2_process_signals``
3. angle estimation             ``step3_extract_angles``
4. velocity estimation          ``step4_estimate_velocity``
5. pose integration             ``step5_integrate_pose``
6. evaluation                   ``step6_evaluate``

Each step's compute is one batched call over the frame axis [F, ...] on
the pipeline's device; the artifacts (``io/artifacts.py``, the reference's
schema) are an optional interop and checkpoint layer, written per frame
from one host copy of the stage's batch, and step 2 resumes from the raw
frames on disk when step 1 did not run in this process.  ``step_times``
are host seconds, each read after the device's queued work is done.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from radar_slam_tpu_torch.aoa import robust as aoa_robust
from radar_slam_tpu_torch.aoa import smoothing
from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.types import (ScattererBatch, Trajectory,
                                             signals_from_numpy)
from radar_slam_tpu_torch.evaluate import (pose_metrics, reports,
                                           velocity_metrics)
from radar_slam_tpu_torch.io import artifacts
from radar_slam_tpu_torch.motion.associate import associate_targets
from radar_slam_tpu_torch.motion.pose import integrate_pose
from radar_slam_tpu_torch.motion.velocity import solve_velocity
from radar_slam_tpu_torch.signal.detect import detect_peaks
from radar_slam_tpu_torch.signal.rds import range_doppler_spectrum
from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch
from radar_slam_tpu_torch.utils.host import device_get, device_put, tree_map
from radar_slam_tpu_torch.utils.profiling import synchronize

logger = logging.getLogger(__name__)


class EgoMotionPipeline:
    """File-based six-step pipeline over a frame sequence, on ``device``
    (the card unless the caller names another)."""

    def __init__(self, cfg: PipelineConfig, output_dir: str,
                 save_artifacts: bool = True, device=DEFAULT):
        self.cfg = cfg
        self.device = resolve(device)
        self.output_dir = Path(output_dir)
        self.save_artifacts = save_artifacts
        self.dirs = artifacts.ensure_stage_dirs(self.output_dir)
        artifacts.save_config(self.output_dir, cfg)
        self.step_times: Dict[str, float] = {}
        # In-memory stage results (tensors on the device).
        self._signals = None
        self._rds = None
        self._detections = None
        self._targets = None
        self._motions = None
        self._trajectory: Optional[Trajectory] = None

    def _elapsed(self, t0: float) -> float:
        synchronize(self.device)
        return time.time() - t0

    # -- step 1 -------------------------------------------------------------

    def step1_synthesize(self, scatterers: ScattererBatch,
                         seed: int = 0) -> torch.Tensor:
        """Raw baseband cubes [F, A, C, S] of scatterer frames [F, Sc].  The
        frames' noise seeds come from ``torch.Generator().manual_seed(seed)``
        (the reference keys ``jax.random.key(seed)``): the noise bits differ
        from the reference's, its statistics do not."""
        t0 = time.time()
        scatterers = device_put(scatterers, self.device)
        self._signals = synthesize_frames_batch(
            scatterers, self.cfg.radar, torch.Generator().manual_seed(seed),
            fidelity=self.cfg.synth_fidelity)
        if self.save_artifacts:
            host = device_get(self._signals)
            for i in range(host.shape[0]):
                artifacts.save_raw_frame(self.dirs["raw_sim"], i, host[i])
            artifacts.save_synthesis_metadata(
                self.dirs["raw_sim"], self.cfg.radar,
                {"total_frames": int(host.shape[0]),
                 "processed_frames": int(host.shape[0]),
                 "valid_scatterers": int(scatterers.valid.sum())})
        self.step_times["step1"] = self._elapsed(t0)
        return self._signals

    # -- step 2 -------------------------------------------------------------

    def step2_process_signals(self, signals: Optional[torch.Tensor] = None):
        """Complex RDS [F, A, R, D] and detections [F, K].  The pipeline
        materializes the RDS by design (its artifacts and step 3's
        signatures read it), so ``fft_mode="fused"`` runs torch's FFTs, as
        the reference falls back to XLA's; ``"pallas"`` runs the fused RDS
        kernel once over the batch."""
        t0 = time.time()
        if signals is None:
            signals = self._signals
        if signals is None:
            signals = self._load_raw_frames()
        cfg = self.cfg
        mode = "fft" if cfg.fft_mode == "fused" else cfg.fft_mode
        rds = range_doppler_spectrum(
            signals.to(self.device), cfg.radar, window=cfg.window,
            chirp_subset=cfg.chirp_subset, doppler_window=cfg.doppler_window,
            fft_mode=mode, dft_precision=cfg.dft_precision)
        det = detect_peaks(rds, cfg.radar, cfg.detection)
        self._rds, self._detections = rds, det
        if self.save_artifacts:
            rds_h, det_h = device_get((rds, det))
            for i in range(rds_h.shape[0]):
                artifacts.save_rds_frame(self.dirs["rds"], i, rds_h[i],
                                         tree_map(lambda x: x[i], det_h))
        self.step_times["step2"] = self._elapsed(t0)
        return rds, det

    # -- step 3 -------------------------------------------------------------

    def step3_extract_angles(self, method: Optional[str] = None):
        """Targets [F, K]: the robust AoA stage over the whole batch, its
        smoother carried from frame to frame."""
        t0 = time.time()
        cfg = self.cfg
        targets, _ = aoa_robust.process_targets_robust(
            self._rds, self._detections,
            smoothing.init_state(cfg.aoa, self.device), cfg.radar, cfg.aoa,
            method=method or cfg.aoa.method)
        self._targets = targets
        if self.save_artifacts:
            host = device_get(targets)
            for i in range(self._rds.shape[0]):
                artifacts.save_angles_frame(self.dirs["angles"], i,
                                            tree_map(lambda x: x[i], host))
        self.step_times["step3"] = self._elapsed(t0)
        return targets

    # -- step 4 -------------------------------------------------------------

    def step4_estimate_velocity(self):
        """Motion estimates [F]: frame f associated with frame f - 1 (frame
        0 with itself, masked out), then the 6-DoF solve."""
        t0 = time.time()
        cfg = self.cfg
        targets = self._targets
        F = targets.range_m.shape[0]
        prev = tree_map(lambda x: torch.cat([x[:1], x[:-1]], dim=0), targets)
        has_prev = torch.arange(F, device=targets.range_m.device) > 0
        assoc = associate_targets(targets, prev, cfg.frame_dt, cfg.velocity)
        assoc = assoc._replace(valid=assoc.valid & has_prev[:, None])
        motions = solve_velocity(
            assoc, cfg.frame_dt, cfg.radar.lambda_c, cfg.velocity,
            v_unambiguous=cfg.radar.max_unambiguous_velocity)
        self._motions = motions
        if self.save_artifacts:
            host = device_get(motions)
            for i in range(F):
                artifacts.save_velocity_frame(self.dirs["velocities"], i,
                                              tree_map(lambda x: x[i], host))
        self.step_times["step4"] = self._elapsed(t0)
        return motions

    # -- step 5 -------------------------------------------------------------

    def step5_integrate_pose(self, timestamps: Optional[np.ndarray] = None):
        """Trajectory of the motion estimates, failed solves zeroed;
        timestamps default to ``arange(F) * frame_dt`` in float32."""
        t0 = time.time()
        m = self._motions
        F = m.velocity.shape[0]
        if timestamps is None:
            timestamps = (torch.arange(F, dtype=torch.float32,
                                       device=self.device)
                          * self.cfg.frame_dt)
        else:
            timestamps = torch.as_tensor(np.asarray(timestamps),
                                         dtype=torch.float32,
                                         device=self.device)
        vel = torch.where(m.success[:, None], m.velocity, 0.0)
        ang = torch.where(m.success[:, None], m.angular_velocity, 0.0)
        traj = integrate_pose(vel, ang, timestamps, self.cfg.pose)
        self._trajectory = traj
        if self.save_artifacts:
            artifacts.save_trajectory(self.dirs["poses"], traj)
        self.step_times["step5"] = self._elapsed(t0)
        return traj

    # -- step 6 -------------------------------------------------------------

    def step6_evaluate(self, gt_velocities: Optional[np.ndarray] = None,
                       gt_poses7: Optional[np.ndarray] = None) -> Dict:
        """Velocity errors against ``gt_velocities`` [F, 6] and APE / RTE
        against ``gt_poses7`` [F, 7] (xyz + wxyz), on the host; the reports
        go to ``evaluation/`` and APE / RTE to its ``summary.json``."""
        t0 = time.time()
        out: Dict = {}
        m = device_get(self._motions)
        est6 = np.concatenate([m.velocity, m.angular_velocity], axis=1)
        if gt_velocities is not None:
            res = velocity_metrics.compute_velocity_errors(est6, gt_velocities)
            trends = velocity_metrics.analyze_error_trends(res)
            out["velocity"] = res
            reports.write_report(
                reports.velocity_report_markdown(res, trends),
                self.dirs["evaluation"] / "velocity_report.md")
        if gt_poses7 is not None and self._trajectory is not None:
            t = device_get(self._trajectory)
            est7 = np.column_stack([t.positions, t.quaternions])
            ape = pose_metrics.compute_ape(est7, gt_poses7)
            rte = pose_metrics.compute_rte(est7, gt_poses7)
            out["ape"], out["rte"] = ape, rte
            reports.write_report(reports.pose_report_markdown(ape, rte),
                                 self.dirs["evaluation"] / "pose_report.md")
        if out:
            reports.save_json(
                {k: v for k, v in out.items() if k != "velocity"},
                self.dirs["evaluation"] / "summary.json")
        self.step_times["step6"] = time.time() - t0
        return out

    # -- orchestration -------------------------------------------------------

    def run_complete_pipeline(self, scatterers: ScattererBatch,
                              timestamps: Optional[np.ndarray] = None,
                              gt_velocities: Optional[np.ndarray] = None,
                              gt_poses7: Optional[np.ndarray] = None,
                              seed: int = 0) -> Dict:
        """All six steps (run_ego_motion_pipeline.py:405-446)."""
        self.step1_synthesize(scatterers, seed)
        self.step2_process_signals()
        self.step3_extract_angles()
        self.step4_estimate_velocity()
        self.step5_integrate_pose(timestamps)
        evals = self.step6_evaluate(gt_velocities, gt_poses7)
        logger.info("pipeline complete: %s", self.step_times)
        return {"step_times": dict(self.step_times), "evaluation": evals,
                "trajectory": self._trajectory}

    # -- resume from artifacts -----------------------------------------------

    def _load_raw_frames(self) -> torch.Tensor:
        files = sorted(self.dirs["raw_sim"].glob("frame_*.npy"))
        if not files:
            raise FileNotFoundError("no raw frames on disk; run step1 first")
        self._signals = signals_from_numpy(
            np.stack([np.load(f) for f in files]), self.device)
        return self._signals
