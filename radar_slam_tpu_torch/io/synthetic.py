"""Synthetic known-truth scenes (the bench scene) for the port.

Counterpart of ``radar_slam_tpu/io/synthetic.py``: a static world point
cloud observed by an ego vehicle under a known constant twist.  The numpy
core is the reference's, unchanged, so the same seed gives bit-identical
scatterer columns; only the last step differs -- the columns become
tensors on a caller-chosen device instead of JAX arrays.  Seeds are plain
integers (the port has no JAX keys).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy


def _rng(seed: int) -> np.random.Generator:
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"scene seeds are integers, got {type(seed)}")
    return np.random.default_rng(int(seed))


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_points: int = 64
    min_range: float = 5.0
    max_range: float = 55.0
    rcs_min_db: float = 5.0
    rcs_max_db: float = 20.0
    azimuth_span_rad: float = 1.4      # initial point placement (+/- span/2)
    # Sensor field of view: points outside are not observed (a ULA cannot
    # tell az from pi - az).
    fov_rad: float = 2.4
    max_scatterers: int = 512


def make_world_points(seed: int, scene: SceneConfig
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Random static world points [N, 2] (x, y) and RCS [N] around origin."""
    rng = _rng(seed)
    r = rng.uniform(scene.min_range, scene.max_range, scene.num_points)
    az = rng.uniform(-scene.azimuth_span_rad / 2, scene.azimuth_span_rad / 2,
                     scene.num_points)
    rcs = rng.uniform(scene.rcs_min_db, scene.rcs_max_db, scene.num_points)
    pts = np.stack([r * np.cos(az), r * np.sin(az)], axis=-1)
    return pts.astype(np.float32), rcs.astype(np.float32)


def corridor_points(seed: int, scene: SceneConfig, path_xy: np.ndarray,
                    lateral: float = 30.0) -> Tuple[np.ndarray, np.ndarray]:
    """Points offset laterally + longitudinally from random path samples, so
    targets stay in view for the whole sequence."""
    rng = _rng(seed)
    n = scene.num_points
    idx = rng.integers(0, len(path_xy), n)
    base = np.asarray(path_xy)[idx]
    offs = rng.uniform(-1.0, 1.0, (n, 2)) * np.array(
        [scene.max_range * 0.8, lateral])
    rcs = rng.uniform(scene.rcs_min_db, scene.rcs_max_db, n)
    return (base + offs).astype(np.float32), rcs.astype(np.float32)


def observe_points(world_xy: np.ndarray, rcs_db: np.ndarray,
                   ego_xy: np.ndarray, ego_yaw: float,
                   v_body: np.ndarray, yaw_rate: float,
                   max_scatterers: int,
                   max_range: float = 1e9,
                   min_range: float = 1.5,
                   fov_rad: float = 2.4) -> Dict[str, np.ndarray]:
    """Project static world points into the ego body frame at one instant:
    numpy columns (range_m, azimuth_rad, rcs_db, vr, valid) padded to
    ``max_scatterers``; vr = -d_b . v_body."""
    world_xy = np.asarray(world_xy, np.float64)
    c, s = np.cos(ego_yaw), np.sin(ego_yaw)
    rel = world_xy - np.asarray(ego_xy)[None, :]
    xb = c * rel[:, 0] + s * rel[:, 1]
    yb = -s * rel[:, 0] + c * rel[:, 1]
    rng_m = np.hypot(xb, yb)
    az = np.arctan2(yb, xb)
    d = np.stack([xb, yb], axis=-1) / np.maximum(rng_m[:, None], 1e-6)
    vr = -(d[:, 0] * v_body[0] + d[:, 1] * v_body[1])

    n = len(world_xy)
    if max_scatterers < n:
        raise ValueError("max_scatterers smaller than point count")
    pad = max_scatterers - n

    def z(x):
        return np.pad(np.asarray(x, np.float32), (0, pad))

    observable = ((rng_m <= max_range) & (rng_m >= min_range)
                  & (np.abs(az) <= fov_rad / 2))
    return {
        "range_m": z(rng_m), "azimuth_rad": z(az), "rcs_db": z(rcs_db),
        "vr": z(vr),
        "valid": np.pad(observable, (0, pad)),
    }


def constant_motion_scene(seed: int, num_frames: int, dt: float,
                          v_body: Tuple[float, float],
                          yaw_rate: float,
                          scene: SceneConfig = SceneConfig(),
                          device="cpu"):
    """Frame sequence under constant body velocity + yaw rate.

    Returns (ScattererBatch [F, S] on ``device``, gt dict of numpy arrays:
    poses [F, 3] (x, y, yaw), velocity_body [3], yaw_rate, timestamps [F])."""
    vb = np.array([v_body[0], v_body[1]], np.float64)
    w = float(yaw_rate)

    # Exact constant-twist path.
    yaws = w * dt * np.arange(num_frames + 1)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1]],
                     axis=-1) * dt
    path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)])

    world, rcs = corridor_points(seed, scene, path)

    frames = [observe_points(world, rcs, path[i], yaws[i], vb, w,
                             scene.max_scatterers, max_range=scene.max_range,
                             fov_rad=scene.fov_rad)
              for i in range(num_frames)]
    gt = {
        "poses": np.concatenate([path[:num_frames],
                                 yaws[:num_frames, None]], axis=-1),
        "velocity_body": np.array([v_body[0], v_body[1], 0.0]),
        "yaw_rate": w,
        "timestamps": np.arange(num_frames) * dt,
    }
    stack = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    return scatterer_batch_from_numpy(stack, device), gt
