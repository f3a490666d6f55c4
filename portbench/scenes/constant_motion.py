"""The bench scene: a static corridor of world points seen by one radar on
an ego vehicle under a constant body velocity and yaw rate.

Frozen copy of ``radar_slam_tpu_torch/io/synthetic.py`` at commit d8c8661
(``corridor_points``, ``observe_points`` and the numpy core of
``constant_motion_scene``, the scene of ``bench.py:69-74`` and
``bench_torch.py:scene``), returning numpy columns instead of tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def corridor_points(rng: np.random.Generator, num_points: int,
                    max_range: float, rcs_min_db: float, rcs_max_db: float,
                    path_xy: np.ndarray, lateral: float = 30.0):
    """Points offset laterally and longitudinally from random path
    samples, so targets stay in view for the whole sequence."""
    idx = rng.integers(0, len(path_xy), num_points)
    base = np.asarray(path_xy)[idx]
    offs = rng.uniform(-1.0, 1.0, (num_points, 2)) * np.array(
        [max_range * 0.8, lateral])
    rcs = rng.uniform(rcs_min_db, rcs_max_db, num_points)
    return (base + offs).astype(np.float32), rcs.astype(np.float32)


def observe_points(world_xy: np.ndarray, rcs_db: np.ndarray,
                   ego_xy: np.ndarray, ego_yaw: float, v_body: np.ndarray,
                   max_scatterers: int, max_range: float = 1e9,
                   min_range: float = 1.5,
                   fov_rad: float = 2.4) -> Dict[str, np.ndarray]:
    """Static world points in the ego body frame at one instant: columns
    (range_m, azimuth_rad, rcs_db, vr, valid) padded to
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
    return {"range_m": z(rng_m), "azimuth_rad": z(az), "rcs_db": z(rcs_db),
            "vr": z(vr), "valid": np.pad(observable, (0, pad))}


def make(scene: Dict, frames: int, seed: int, max_scatterers: int,
         dt: float):
    """(columns {name: [F, S_max]}, rig None) of one sequence of
    ``frames`` frames; the world drawn from ``seed``."""
    vb = np.array(scene["v_body"], np.float64)
    w = float(scene["yaw_rate"])
    yaws = w * dt * np.arange(frames + 1)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1]],
                     axis=-1) * dt
    path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)])
    world, rcs = corridor_points(np.random.default_rng(seed),
                                 scene["num_points"], scene["max_range"],
                                 scene["rcs_min_db"], scene["rcs_max_db"],
                                 path)
    cols = [observe_points(world, rcs, path[i], yaws[i], vb, max_scatterers,
                           max_range=scene["max_range"],
                           fov_rad=scene["fov_rad"])
            for i in range(frames)]
    return {k: np.stack([f[k] for f in cols]) for k in cols[0]}, None
