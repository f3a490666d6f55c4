"""Stage artifacts on disk: the six-step pipeline's interop and resume layer.

Counterpart of ``radar_slam_tpu/io/artifacts.py``, with the same file
names, npz keys, dtypes and shapes, so that each package's loaders read the
other's artifacts: ``raw_sim/frame_XXXX.npy`` (+ ``synthesis_metadata
.json``), ``rds/frame_XXXX_rds.npy`` + ``frame_XXXX_peaks.npz``,
``angles/frame_XXXX_angles.npz``, ``velocities/frame_XXXX_velocity.npz``,
``poses/trajectory.npz`` + ``trajectory.txt``, and ``pipeline_config.json``
(``dataclasses.asdict`` of the configuration; the port's config copy gives
the same JSON byte for byte).

The per-frame savers take one frame's arrays: numpy (what the pipeline
passes, sliced from one host copy of a stage's batch) or tensors (read back
one by one).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from radar_slam_tpu_torch.core.config import PipelineConfig, RadarConfig
from radar_slam_tpu_torch.core.types import Detections, Targets, Trajectory
from radar_slam_tpu_torch.utils.host import device_get

STAGE_DIRS = ("raw_sim", "rds", "angles", "velocities", "poses", "evaluation")


def ensure_stage_dirs(root: str | Path) -> Dict[str, Path]:
    root = Path(root)
    out = {}
    for d in STAGE_DIRS:
        p = root / d
        p.mkdir(parents=True, exist_ok=True)
        out[d] = p
    return out


def frame_name(i: int) -> str:
    return f"frame_{i:04d}"


# -- raw signals --------------------------------------------------------------

def save_raw_frame(path: Path, i: int, signals) -> Path:
    """One ADC cube [A, C, S] complex64."""
    f = path / f"{frame_name(i)}.npy"
    np.save(f, device_get(signals))
    return f


def load_raw_frame(path: Path, i: int) -> np.ndarray:
    return np.load(path / f"{frame_name(i)}.npy")


def save_synthesis_metadata(path: Path, radar: RadarConfig,
                            stats: Dict) -> Path:
    f = path / "synthesis_metadata.json"
    with open(f, "w") as fh:
        json.dump({
            "radar_params": {
                "fc": radar.fc, "bandwidth": radar.bandwidth,
                "chirp_duration": radar.chirp_duration, "pri": radar.pri,
                "num_chirps": radar.num_chirps,
                "num_antennas": radar.num_antennas,
                "antenna_spacing": radar.spacing,
                "sampling_rate": radar.sampling_rate,
            },
            "processing_stats": stats,
        }, fh, indent=2)
    return f


# -- RDS + peaks --------------------------------------------------------------

def save_rds_frame(path: Path, i: int, rds, detections: Detections,
                   power_db: Optional[np.ndarray] = None) -> Path:
    """One RDS [A, R, D] complex64 and its detections [K] (one frame's
    :class:`Detections` fields)."""
    np.save(path / f"{frame_name(i)}_rds.npy", device_get(rds))
    d = {k: device_get(v) for k, v in detections._asdict().items()}
    if power_db is not None:
        d["power_spectrum_db"] = device_get(power_db)
    np.savez(path / f"{frame_name(i)}_peaks.npz", **d)
    return path / f"{frame_name(i)}_rds.npy"


def load_rds_frame(path: Path, i: int):
    rds = np.load(path / f"{frame_name(i)}_rds.npy")
    with np.load(path / f"{frame_name(i)}_peaks.npz") as z:
        peaks = {k: z[k] for k in z.files}
    return rds, peaks


# -- angles -------------------------------------------------------------------

def save_angles_frame(path: Path, i: int, targets: Targets) -> Path:
    """One frame's :class:`Targets` fields ([K], signatures [K, A])."""
    f = path / f"{frame_name(i)}_angles.npz"
    np.savez(f, **{k: device_get(v) for k, v in targets._asdict().items()})
    return f


def load_angles_frame(path: Path, i: int) -> Dict[str, np.ndarray]:
    with np.load(path / f"{frame_name(i)}_angles.npz") as z:
        return {k: z[k] for k in z.files}


# -- velocities ---------------------------------------------------------------

def save_velocity_frame(path: Path, i: int, motion) -> Path:
    """One frame's :class:`MotionEstimate` fields (velocity [3], scalars)."""
    f = path / f"{frame_name(i)}_velocity.npz"
    m = device_get(motion)
    np.savez(f,
             velocity=np.asarray(m.velocity),
             angular_velocity=np.asarray(m.angular_velocity),
             rmse=np.asarray(m.rmse),
             max_residual=np.asarray(m.max_residual),
             num_targets=np.asarray(m.num_targets),
             success=np.asarray(m.success),
             cost=np.asarray(m.cost))
    return f


def load_velocity_frame(path: Path, i: int) -> Dict[str, np.ndarray]:
    with np.load(path / f"{frame_name(i)}_velocity.npz") as z:
        return {k: z[k] for k in z.files}


# -- trajectory ---------------------------------------------------------------

def save_trajectory(path: Path, traj: Trajectory,
                    name: str = "trajectory") -> Path:
    """``<name>.npz`` (the trajectory's fields and its rotation matrices,
    read back at once) and ``<name>.txt`` (timestamp x y z roll pitch
    yaw)."""
    t = device_get(traj._asdict())
    t["rotations"] = device_get(traj.rotations)
    f = Path(path) / f"{name}.npz"
    np.savez(f, **{k: np.asarray(t[k]) for k in (
        "timestamps", "positions", "orientations", "rotations",
        "quaternions", "velocities", "angular_velocities")})
    ts, pos, eul = t["timestamps"], t["positions"], t["orientations"]
    with open(Path(path) / f"{name}.txt", "w") as fh:
        fh.write("# timestamp x y z roll pitch yaw\n")
        for k in range(len(ts)):
            fh.write(f"{ts[k]:.6f} {pos[k,0]:.6f} {pos[k,1]:.6f} "
                     f"{pos[k,2]:.6f} {eul[k,0]:.6f} {eul[k,1]:.6f} "
                     f"{eul[k,2]:.6f}\n")
    return f


def load_trajectory(path: Path,
                    name: str = "trajectory") -> Dict[str, np.ndarray]:
    with np.load(Path(path) / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


# -- pipeline config snapshot -------------------------------------------------

def save_config(path: Path, cfg: PipelineConfig) -> Path:
    f = Path(path) / "pipeline_config.json"
    with open(f, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, default=str)
    return f
