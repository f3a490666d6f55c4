"""Host-side visualization (parity with ``scripts/visualize_results.py``
``RadarDataVisualizer`` and ``scripts/quick_visualize.py``).

Counterpart of ``radar_slam_tpu/viz/plots.py``: a copy whose functions
also take tensors (read back to the host first) and save the same PNGs
with the non-interactive backend.  matplotlib is imported by
:func:`pyplot` when a function draws, not with the module, so the port's
modules import where it is missing (the card's machine); the CLI calls
:func:`pyplot` first in the subcommands that draw.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from radar_slam_tpu_torch.core.config import RadarConfig
from radar_slam_tpu_torch.utils.host import device_get


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(x) -> np.ndarray:
    """``x`` (an array or a tensor) as a numpy array."""
    return np.asarray(device_get(x))


def plot_raw_signals(signals: np.ndarray, save_path: str | Path,
                     antenna: int = 0, chirp: int = 0) -> Path:
    """Real/imag/magnitude of one chirp (visualize_results.py raw panel)."""
    plt = pyplot()
    s = _host(signals)[antenna, chirp]
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    axes[0].plot(s.real); axes[0].set_ylabel("I")
    axes[1].plot(s.imag); axes[1].set_ylabel("Q")
    axes[2].plot(np.abs(s)); axes[2].set_ylabel("|s|")
    axes[2].set_xlabel("fast-time sample")
    axes[0].set_title(f"Raw signal, antenna {antenna}, chirp {chirp}")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def plot_rds(rds: np.ndarray, cfg: RadarConfig, save_path: str | Path,
             antenna: int = 0,
             detections: Optional[Dict[str, np.ndarray]] = None) -> Path:
    """Range-Doppler power map + optional detection markers
    (dechirp.py:280-310 / visualize_results.py RDS panel)."""
    plt = pyplot()
    p = np.abs(_host(rds)[antenna]) ** 2
    p_db = 10 * np.log10(p + 1e-12)
    R, D = p_db.shape
    ranges = np.arange(R) * cfg.range_resolution
    prf = cfg.prf
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(p_db, aspect="auto", origin="lower",
                   extent=[-prf / 2, prf / 2, ranges[0], ranges[-1]],
                   cmap="viridis")
    fig.colorbar(im, label="Power (dB)")
    if detections is not None:
        ok = _host(detections["valid"]).astype(bool)
        ax.scatter(_host(detections["doppler_hz"])[ok],
                   _host(detections["range_m"])[ok],
                   s=40, facecolors="none", edgecolors="r")
    ax.set_xlabel("Doppler (Hz)")
    ax.set_ylabel("Range (m)")
    ax.set_title(f"Range-Doppler spectrum (antenna {antenna})")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def plot_angle_spectrum(grid_deg: np.ndarray, spectra: np.ndarray,
                        angles_deg: np.ndarray, save_path: str | Path,
                        max_curves: int = 8) -> Path:
    """Per-target angle spectra (angle_estimation.py:311-366 panel)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    for k in range(min(len(spectra), max_curves)):
        s = spectra[k] / (np.max(spectra[k]) + 1e-12)
        ax.plot(grid_deg, 10 * np.log10(s + 1e-9), alpha=0.7)
        ax.axvline(angles_deg[k], ls="--", lw=0.5, c="k")
    ax.set_xlabel("Azimuth (deg)")
    ax.set_ylabel("Normalized spectrum (dB)")
    ax.set_title("AoA spectra")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def plot_trajectory(positions: np.ndarray, save_path: str | Path,
                    gt_positions: Optional[np.ndarray] = None,
                    orientations: Optional[np.ndarray] = None) -> Path:
    """2-D trajectory with optional GT + heading arrows
    (pose_integration.py:271-350 / complete-analysis panel 1)."""
    plt = pyplot()
    pos = _host(positions)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(pos[:, 0], pos[:, 1], "g-", marker=".", label="estimate")
    if gt_positions is not None:
        gp = _host(gt_positions)
        ax.plot(gp[:, 0], gp[:, 1], "b-", marker="o", ms=3,
                label="ground truth")
    if orientations is not None:
        yaw = _host(orientations)[:, -1]
        step = max(len(pos) // 20, 1)
        ax.quiver(pos[::step, 0], pos[::step, 1],
                  np.cos(yaw[::step]), np.sin(yaw[::step]),
                  width=0.003, scale=30, color="r")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.axis("equal")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title("Trajectory")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def plot_velocity_profile(timestamps: np.ndarray, velocities: np.ndarray,
                          save_path: str | Path,
                          gt_velocities: Optional[np.ndarray] = None) -> Path:
    plt = pyplot()
    ts = _host(timestamps)
    v = _host(velocities)
    fig, axes = plt.subplots(v.shape[1], 1, figsize=(10, 2.2 * v.shape[1]),
                             sharex=True)
    labels = ["vx", "vy", "vz", "wx", "wy", "wz"]
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(ts, v[:, i], "g-", label="estimate")
        if gt_velocities is not None and i < gt_velocities.shape[1]:
            ax.plot(ts, _host(gt_velocities)[:, i], "b--", label="GT")
        ax.set_ylabel(labels[i] if i < 6 else str(i))
        ax.grid(alpha=0.3)
    np.atleast_1d(axes)[0].legend()
    np.atleast_1d(axes)[-1].set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


def comprehensive_overview(results: Dict, save_path: str | Path) -> Path:
    """2x3 summary figure (radarscenes_complete_analysis.py:353-465)."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    est = _host(results.get("estimated_trajectory", np.zeros((0, 3))))
    gt = _host(results.get("ground_truth_trajectory", np.zeros((0, 3))))

    ax = axes[0, 0]
    if len(gt):
        ax.plot(gt[:, 0], gt[:, 1], "b-o", ms=3, label="GT")
    if len(est):
        ax.plot(est[:, 0], est[:, 1], "g-.", label="estimate")
    ax.set_title("Trajectory"); ax.legend(); ax.axis("equal")

    ax = axes[0, 1]
    if len(est) and len(gt):
        err = np.linalg.norm(est[:, :2] - gt[:len(est), :2], axis=1)
        ax.plot(err)
    ax.set_title("Position error (m)")

    ax = axes[0, 2]
    if len(est) and len(gt):
        ax.plot(np.abs(est[:, 2] - gt[:len(est), 2]))
    ax.set_title("Yaw error (rad)")

    ax = axes[1, 0]
    vel = _host(results.get("velocity_estimates", np.zeros((0, 6))))
    if len(vel):
        ax.plot(vel[:, 0], label="vx"); ax.plot(vel[:, 1], label="vy")
        ax.legend()
    ax.set_title("Velocity estimates (m/s)")

    ax = axes[1, 1]
    nt = results.get("num_targets", [])
    if len(nt):
        ax.plot(nt)
    ax.set_title("Reliable targets / frame")

    ax = axes[1, 2]
    pt = results.get("processing_times", [])
    if len(pt):
        ax.plot(_host(pt) * 1e3)
    ax.set_title("Processing time (ms)")

    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)
