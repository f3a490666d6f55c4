"""Evaluation error plots (parity with the figures the reference evaluators
emit alongside their reports: ``evaluation/compute_velocity_error.py:182-251``
velocity error curves / distributions, ``compute_pose_error.py:449-517``
APE-over-time and trajectory-overlay panels).

Counterpart of ``radar_slam_tpu/evaluate/plots.py``: a copy whose
functions also take tensors (read back to the host first).  matplotlib is
imported when a function draws (``viz.plots.pyplot``), not with the
module.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from radar_slam_tpu_torch.viz.plots import _host, pyplot


VELOCITY_COMPONENTS = ("vx", "vy", "vz", "wx", "wy", "wz")


def plot_velocity_errors(est: np.ndarray, gt: np.ndarray,
                         save_path: str | Path,
                         timestamps: Optional[np.ndarray] = None,
                         window: int = 5) -> Path:
    """Per-component velocity error curves with a moving average, plus an
    error-distribution panel (compute_velocity_error.py:182-251 figure)."""
    plt = pyplot()
    est = _host(est).astype(np.float64)
    gt = _host(gt).astype(np.float64)
    n, k = est.shape
    t = (_host(timestamps) if timestamps is not None
         else np.arange(n, dtype=np.float64))
    err = est - gt

    fig, axes = plt.subplots(2, 3, figsize=(15, 8), sharex=True)
    for i in range(min(k, 6)):
        ax = axes.flat[i]
        ax.plot(t, err[:, i], lw=0.8, alpha=0.6, label="error")
        if n >= window:
            ma = np.convolve(err[:, i], np.ones(window) / window,
                             mode="valid")
            ax.plot(t[window - 1:], ma, lw=1.6, label=f"MA({window})")
        ax.axhline(0.0, color="k", lw=0.5)
        unit = "m/s" if i < 3 else "rad/s"
        ax.set_title(f"{VELOCITY_COMPONENTS[i]} error "
                     f"(RMSE {np.sqrt(np.mean(err[:, i] ** 2)):.3f} {unit})")
        ax.grid(alpha=0.3)
    axes.flat[0].legend(loc="upper right", fontsize=8)
    for ax in axes[-1]:
        ax.set_xlabel("time [s]" if timestamps is not None else "frame")
    fig.suptitle("Velocity estimation errors")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def plot_pose_errors(ape: Dict, save_path: str | Path,
                     est_positions: Optional[np.ndarray] = None,
                     gt_positions: Optional[np.ndarray] = None) -> Path:
    """APE position/orientation error over the trajectory + optional XY
    overlay (compute_pose_error.py:449-517 figure)."""
    plt = pyplot()
    dp = _host(ape["position_errors"])
    dr = _host(ape["orientation_errors"])
    ncols = 3 if est_positions is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 4))

    axes[0].plot(dp, lw=1.0)
    axes[0].axhline(ape["position_rmse"], color="r", ls="--",
                    label=f"RMSE {ape['position_rmse']:.3f} m")
    axes[0].set_title("APE position [m]")
    axes[0].set_xlabel("pose index")
    axes[0].legend(fontsize=8)
    axes[0].grid(alpha=0.3)

    axes[1].plot(dr, lw=1.0, color="tab:orange")
    axes[1].axhline(ape["orientation_rmse"], color="r", ls="--",
                    label=f"RMSE {ape['orientation_rmse']:.3f} rad")
    axes[1].set_title("APE orientation [rad]")
    axes[1].set_xlabel("pose index")
    axes[1].legend(fontsize=8)
    axes[1].grid(alpha=0.3)

    if est_positions is not None and gt_positions is not None:
        e = _host(est_positions)
        g = _host(gt_positions)
        axes[2].plot(g[:, 0], g[:, 1], "k-", lw=1.2, label="ground truth")
        axes[2].plot(e[:, 0], e[:, 1], "b--", lw=1.2, label="estimate")
        axes[2].set_title("Trajectory (XY)")
        axes[2].set_xlabel("x [m]")
        axes[2].set_ylabel("y [m]")
        axes[2].axis("equal")
        axes[2].legend(fontsize=8)
        axes[2].grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def plot_rte(rte: Dict, save_path: str | Path) -> Path:
    """RTE RMSE / mean +- std per segment length (compute_pose_error.py RTE
    panel)."""
    plt = pyplot()
    segs, rmse, mean, std = [], [], [], []
    for name in sorted(rte, key=lambda s: float(s[4:-1])):
        m = rte[name]
        segs.append(float(name[4:-1]))
        rmse.append(m["rmse"])
        mean.append(m["mean"])
        std.append(m["std"])
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.errorbar(segs, mean, yerr=std, fmt="o-", capsize=4,
                label="mean +- std")
    ax.plot(segs, rmse, "s--", color="tab:red", label="RMSE")
    ax.set_xlabel("segment length [m]")
    ax.set_ylabel("relative translation error [m]")
    ax.set_title("Relative Trajectory Error")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def emit_error_plots(out_dir: str | Path,
                     ape: Optional[Dict] = None,
                     rte: Optional[Dict] = None,
                     velocities_est: Optional[np.ndarray] = None,
                     velocities_gt: Optional[np.ndarray] = None,
                     est_positions: Optional[np.ndarray] = None,
                     gt_positions: Optional[np.ndarray] = None,
                     timestamps: Optional[np.ndarray] = None
                     ) -> Sequence[Path]:
    """Write whichever error figures the available inputs support; returns
    the paths written.  This is what the CLI ``evaluate`` command calls next
    to its markdown reports (the reference couples figure emission into its
    evaluator classes)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    if velocities_est is not None and velocities_gt is not None:
        written.append(plot_velocity_errors(
            velocities_est, velocities_gt, out / "velocity_errors.png",
            timestamps=timestamps))
    if ape is not None:
        written.append(plot_pose_errors(ape, out / "pose_errors.png",
                                        est_positions=est_positions,
                                        gt_positions=gt_positions))
    if rte:
        written.append(plot_rte(rte, out / "rte.png"))
    return written
