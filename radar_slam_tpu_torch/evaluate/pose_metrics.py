"""Planar trajectory error metrics.

Counterpart of ``radar_slam_tpu/evaluate/pose_metrics.py:
planar_pose_errors`` -- host-side numpy in float64, as in the reference;
tensors are accepted and read back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def planar_pose_errors(est_xyyaw, gt_xyyaw,
                       velocities_est: Optional[np.ndarray] = None,
                       velocities_gt: Optional[np.ndarray] = None,
                       wrap_yaw: bool = True) -> Dict:
    """Position / yaw RMSE + MAE + max, velocity RMSE and trajectory length
    error of planar (x, y, yaw) tracks.  ``wrap_yaw`` wraps yaw differences
    into (-pi, pi] before taking magnitudes."""
    est = _host(est_xyyaw)
    gt = _host(gt_xyyaw)
    dp = np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)
    dyaw = est[:, 2] - gt[:, 2]
    if wrap_yaw:
        dyaw = np.arctan2(np.sin(dyaw), np.cos(dyaw))
    dyaw = np.abs(dyaw)
    out = {
        "position_rmse": float(np.sqrt(np.mean(dp ** 2))),
        "position_mae": float(np.mean(dp)),
        "position_max_error": float(np.max(dp)),
        "yaw_rmse": float(np.sqrt(np.mean(dyaw ** 2))),
        "yaw_mae": float(np.mean(dyaw)),
        "yaw_max_error": float(np.max(dyaw)),
    }
    if velocities_est is not None and velocities_gt is not None:
        ve = np.linalg.norm(_host(velocities_est) - _host(velocities_gt),
                            axis=1)
        out["velocity_rmse"] = float(np.sqrt(np.mean(ve ** 2)))
        out["velocity_mae"] = float(np.mean(ve))
    if len(est) > 1:
        le = np.sum(np.linalg.norm(np.diff(est[:, :2], axis=0), axis=1))
        lg = np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1))
        out["trajectory_length_error"] = float(abs(le - lg) / max(lg, 1e-6))
    return out
