"""The 3-D scene: a static corridor of world points with heights, seen by
one planar-array radar on an ego vehicle that climbs under a constant body
velocity (v_x, v_y, v_z) and yaw rate -- a spiral ramp.

Frozen copy of the numpy core of ``radar_slam_tpu_torch/io/synthetic.py:
constant_motion_scene_3d`` at commit 735e3d6 (its helix, its polar
observation with elevation, its radial velocity vr = -d . (v + w x p)),
returning numpy columns, with three changes (the configuration's
``assumed``):

- a world point's height is uniform in +-``z_span`` about the path's
  height at the path sample it was drawn near (the original draws heights
  about 0 once, so a climbing ego leaves every point below it);
- a point is observable only inside the elevation field of view,
  +-``el_fov_deg`` (the AoA grid's), besides range and azimuth;
- the corridor (``corridor_points``' draws, in their order) holds
  ``points_per_m`` points per metre of the path, extended by
  ``max_range`` at both ends so that the first and last frames look into
  a full corridor, and each frame reports its observable points in world
  order in the first slots (at most S_max).  The configuration's density
  keeps as many points in view as the scene of ``tests/test_elevation.py``
  (48 points about its 10-frame path: 20.8 in view a frame); the bench
  corridor's 96 points, spread over 2,048 frames of a helix that never
  comes back, would keep a median of 2.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

COLUMNS = ("range_m", "azimuth_rad", "elevation_rad", "rcs_db", "vr")


def helix(vb: np.ndarray, w: float, dt: float, first: int, last: int):
    """(positions [n, 3], yaws [n]) of path samples ``first`` ..
    ``last`` (sample 0 at the origin): each step the body velocity turned
    by the yaw before it, v_z along z."""
    k = np.arange(first, last + 1)
    yaws = w * dt * k
    c, s = np.cos(yaws), np.sin(yaws)
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1],
                      np.full(len(k), vb[2])], axis=-1) * dt
    path = np.concatenate([np.zeros((1, 3)), np.cumsum(steps[:-1], axis=0)])
    return path - path[-first], yaws


def world_points(rng: np.random.Generator, scene: Dict, path: np.ndarray):
    """World points [n, 3] and their RCS [n] about random samples of
    ``path`` [P, 3]: the corridor's offsets in x and y (the frozen
    ``corridor_points``' draws), then each height about its sample's."""
    length = float(np.sum(np.linalg.norm(np.diff(path[:, :2], axis=0),
                                         axis=-1)))
    n = int(round(scene["points_per_m"] * length))
    idx = rng.integers(0, len(path), n)
    offs = rng.uniform(-1.0, 1.0, (n, 2)) * np.array(
        [scene["max_range"] * 0.8, 30.0])
    rcs = rng.uniform(scene["rcs_min_db"], scene["rcs_max_db"], n)
    z = path[idx, 2] + rng.uniform(-scene["z_span"], scene["z_span"], n)
    world = np.concatenate([path[idx, :2] + offs, z[:, None]], axis=-1)
    return world, rcs


def observe(world: np.ndarray, rcs: np.ndarray, ego: np.ndarray,
            yaw: float, vb: np.ndarray, w: float, scene: Dict):
    """The observable points at one instant in the ego body frame: columns
    (range, azimuth, elevation, RCS, vr) [m] and the mask [n]."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    rel = world - ego[None, :]
    xb = cy * rel[:, 0] + sy * rel[:, 1]
    yb = -sy * rel[:, 0] + cy * rel[:, 1]
    zb = rel[:, 2]
    rng_m = np.sqrt(xb * xb + yb * yb + zb * zb)
    rh = np.hypot(xb, yb)
    az = np.arctan2(yb, xb)
    el = np.arctan2(zb, np.maximum(rh, 1e-6))
    d = np.stack([xb, yb, zb], -1) / np.maximum(rng_m[:, None], 1e-6)
    # vr = -d . (v + w x p), planar yaw: w x p = (-w yb, w xb, 0).
    vr = -(d[:, 0] * (vb[0] - w * yb) + d[:, 1] * (vb[1] + w * xb)
           + d[:, 2] * vb[2])
    ok = ((rng_m <= scene["max_range"]) & (rng_m >= 1.5)
          & (np.abs(az) <= scene["fov_rad"] / 2)
          & (np.abs(el) <= np.deg2rad(scene["el_fov_deg"])))
    return dict(zip(COLUMNS, (rng_m, az, el, rcs, vr))), ok


def make(scene: Dict, frames: int, seed: int, max_scatterers: int,
         dt: float):
    """(columns {name: [F, S_max]} with ``elevation_rad``, rig None) of one
    sequence of ``frames`` frames; the world drawn from ``seed``."""
    vb = np.array(scene["v_body"], np.float64)
    w = float(scene["yaw_rate"])
    ext = int(np.ceil(scene["max_range"] / (np.hypot(vb[0], vb[1]) * dt)))
    path, yaws = helix(vb, w, dt, -ext, frames + ext)
    world, rcs = world_points(np.random.default_rng(seed), scene, path)
    cols = {k: np.zeros((frames, max_scatterers), np.float32)
            for k in COLUMNS}
    valid = np.zeros((frames, max_scatterers), bool)
    for i in range(frames):
        obs, ok = observe(world, rcs, path[ext + i], yaws[ext + i], vb, w,
                          scene)
        idx = np.flatnonzero(ok)[:max_scatterers]
        for k in COLUMNS:
            cols[k][i, :len(idx)] = obs[k][idx]
        valid[i, :len(idx)] = True
    cols["valid"] = valid
    return cols, None
