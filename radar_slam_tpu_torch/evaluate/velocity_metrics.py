"""Velocity error evaluation: per-component and overall error metrics and
their trend analysis.

Counterpart of ``radar_slam_tpu/evaluate/velocity_metrics.py`` -- a copy of
its host-side numpy in float64 (metric names and structure as the
reference's ``compute_velocity_error.py:46-180``: per-component rmse / mae
/ bias / std / min_error / max_error / median_error / q25_error / q75_error
plus overall metrics; centered moving average, linear drift, variance).
Tensors are accepted and read back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from radar_slam_tpu_torch.evaluate.pose_metrics import _host

COMPONENTS = ("vx", "vy", "vz", "wx", "wy", "wz")


def compute_velocity_errors(estimated: np.ndarray, ground_truth: np.ndarray,
                            timestamps: Optional[np.ndarray] = None,
                            components: Sequence[str] = COMPONENTS) -> Dict:
    """Per-component + overall velocity error metrics.

    Args:
        estimated / ground_truth: [N, C] arrays (C = len(components); the
            reference uses 6: vx..wz).
    """
    estimated = _host(estimated)
    ground_truth = _host(ground_truth)
    if estimated.shape != ground_truth.shape:
        raise ValueError("Estimated and ground truth velocities must have the "
                         "same shape")
    n, c = estimated.shape
    if c != len(components):
        raise ValueError(f"Expected {len(components)} components, got {c}")

    errors = estimated - ground_truth
    component_metrics = {}
    for i, name in enumerate(components):
        e = errors[:, i]
        component_metrics[name] = {
            "rmse": float(np.sqrt(np.mean(e ** 2))),
            "mae": float(np.mean(np.abs(e))),
            "bias": float(np.mean(e)),
            "std": float(np.std(e)),
            "min_error": float(np.min(e)),
            "max_error": float(np.max(e)),
            "median_error": float(np.median(e)),
            "q25_error": float(np.percentile(e, 25)),
            "q75_error": float(np.percentile(e, 75)),
        }

    results = {
        "num_samples": n,
        "components": list(components),
        "errors": errors,
        "estimated_velocities": estimated,
        "ground_truth_velocities": ground_truth,
        "component_metrics": component_metrics,
        "overall_metrics": {
            "rmse": float(np.sqrt(np.mean(errors ** 2))),
            "mae": float(np.mean(np.abs(errors))),
            "bias": float(np.mean(errors)),
            "std": float(np.std(errors)),
        },
    }
    if timestamps is not None:
        results["timestamps"] = (timestamps.detach().cpu().numpy()
                                 if hasattr(timestamps, "detach")
                                 else np.asarray(timestamps))
    return results


def analyze_error_trends(error_results: Dict, window_size: int = 10) -> Dict:
    """Moving-average + linear-drift trend analysis
    (compute_velocity_error.py:138-180), vectorized."""
    errors = np.asarray(error_results["errors"], np.float64)
    n, c = errors.shape
    timestamps = np.asarray(error_results.get("timestamps", np.arange(n)),
                            np.float64)

    # Centered moving average with shrinking edges (reference loop semantics).
    half = window_size // 2
    csum = np.vstack([np.zeros((1, c)), np.cumsum(errors, axis=0)])
    start = np.maximum(0, np.arange(n) - half)
    end = np.minimum(n, np.arange(n) + half + 1)
    moving_avg = (csum[end] - csum[start]) / (end - start)[:, None]

    # Linear drift: slope of degree-1 fit per component.
    t = timestamps - timestamps.mean()
    denom = np.sum(t ** 2)
    drift = (t @ (errors - errors.mean(axis=0))) / max(denom, 1e-30)

    return {
        "moving_avg_errors": moving_avg,
        "drift_coefficients": drift,
        "error_variance": np.var(errors, axis=0),
        "window_size": window_size,
    }
