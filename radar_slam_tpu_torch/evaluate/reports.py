"""Markdown evaluation reports and JSON results.

Counterpart of ``radar_slam_tpu/evaluate/reports.py`` -- a copy of its
report writers (the reference's ``compute_velocity_error.py:182-251`` and
``compute_pose_error.py:449-517``), whose JSON converter also takes
tensors.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _json_safe(obj):
    """JSON-ready copy of ``obj``: numpy arrays and scalars, and tensors
    (read back to the host; 0-d ones as scalars), as Python values
    (radarscenes_complete_analysis.py:468-491)."""
    if hasattr(obj, "detach"):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def save_json(results: Dict, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_json_safe(results), f, indent=2)


def velocity_report_markdown(results: Dict,
                             trends: Optional[Dict] = None) -> str:
    lines = ["# Velocity Error Evaluation Report", ""]
    lines += [f"Samples: {results['num_samples']}", ""]
    om = results["overall_metrics"]
    lines += ["## Overall Metrics", "",
              "| Metric | Value |", "|---|---|"]
    for k in ("rmse", "mae", "bias", "std"):
        lines.append(f"| {k.upper()} | {om[k]:.6f} |")
    lines += ["", "## Per-Component Metrics", "",
              "| Component | RMSE | MAE | Bias | Std | Median | Q25 | Q75 | Min | Max |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    for name, m in results["component_metrics"].items():
        lines.append(
            f"| {name} | {m['rmse']:.4f} | {m['mae']:.4f} | {m['bias']:.4f} | "
            f"{m['std']:.4f} | {m['median_error']:.4f} | {m['q25_error']:.4f} | "
            f"{m['q75_error']:.4f} | {m['min_error']:.4f} | {m['max_error']:.4f} |")
    if trends is not None:
        lines += ["", "## Trend Analysis", "",
                  f"Window size: {trends['window_size']}",
                  "",
                  "| Component | Drift [unit/s] | Variance |", "|---|---|---|"]
        for i, name in enumerate(results["components"]):
            lines.append(f"| {name} | {trends['drift_coefficients'][i]:.6f} | "
                         f"{trends['error_variance'][i]:.6f} |")
    return "\n".join(lines) + "\n"


def pose_report_markdown(ape: Dict, rte: Optional[Dict] = None) -> str:
    lines = ["# Pose Error Evaluation Report", "", "## APE (Absolute Pose Error)",
             "", "| Metric | RMSE | Mean | Std | Max |", "|---|---|---|---|---|"]
    for prefix, unit in (("position", "m"), ("orientation", "rad"), ("pose", "-")):
        lines.append(
            f"| {prefix} [{unit}] | {ape[f'{prefix}_rmse']:.6f} | "
            f"{ape[f'{prefix}_mean']:.6f} | {ape[f'{prefix}_std']:.6f} | "
            f"{ape[f'{prefix}_max']:.6f} |")
    if rte:
        lines += ["", "## RTE (Relative Trajectory Error)", "",
                  "| Segment | RMSE [m] | Mean | Std | Max | N |",
                  "|---|---|---|---|---|---|"]
        for seg, m in sorted(rte.items()):
            lines.append(f"| {seg} | {m['rmse']:.6f} | {m['mean']:.6f} | "
                         f"{m['std']:.6f} | {m['max']:.6f} | {m['num_segments']} |")
    return "\n".join(lines) + "\n"


def write_report(text: str, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(text)
