"""A RadarScenes-layout recording: four mounted radars on an ego vehicle
driving through a static corridor, ~70 returns per sensor and frame.

Frozen copy of ``chip_smoke.py:rs_recording`` at commit d8c8661 (the scene
of ``tests/test_cli_dataset.py:45-113`` with the corridor's points at the
fixture's density over the whole path, the same draws in the same order),
with what the port's loader (``io/radarscenes.py``:
``frames_as_batches_rig(host=True)``) makes of it: per rig frame and sensor
the returns in sensor-frame polar (range, azimuth, RCS, radial velocity),
in timestamp order, padded to ``max_scatterers``.  Each frame's returns
fill its own rig frame (the recording's timestamps lie inside its 100 ms
window).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make(scene: Dict, frames: int, seed: int, max_scatterers: int,
         dt: float):
    """(columns {name: [F, B, S_max]}, rig ((x, y, yaw), ...)) of one
    recording of ``frames`` rig frames drawn from ``seed``."""
    mounts = tuple(tuple(m) for m in scene["mounts"])
    v_ego, per = float(scene["v_ego"]), int(scene["returns_per_sensor"])
    rng = np.random.default_rng(seed)
    length = v_ego * frames * dt + 110.0
    n_world = int(round(900 * length / (v_ego * 12 * dt + 110.0)))
    wx = rng.uniform(-40, v_ego * frames * dt + 70, n_world)
    wy = np.concatenate([rng.uniform(3, 9, n_world // 2),
                         rng.uniform(-9, -3, n_world - n_world // 2)])
    rcs = rng.uniform(0, 25, n_world)
    B = len(mounts)
    shape = (frames, B, max_scatterers)
    cols = {k: np.zeros(shape, np.float32)
            for k in ("range_m", "azimuth_rad", "rcs_db", "vr")}
    valid = np.zeros(shape, bool)
    for f in range(frames):
        ex = v_ego * f * dt
        for b, (mx, my, myaw) in enumerate(mounts):
            dx, dy = wx - (ex + mx), wy - my
            r_v = np.hypot(dx, dy)
            az_v = np.arctan2(dy, dx)
            az_s = az_v - myaw
            az_s = np.arctan2(np.sin(az_s), np.cos(az_s))
            vr = -np.cos(az_v) * v_ego
            keep = (np.abs(az_s) < 0.9) & (r_v > 1.5) & (r_v < 60.0)
            idx = rng.permutation(np.nonzero(keep)[0])[:per]
            ts = rng.integers(0, 90_000, size=len(idx))
            idx = idx[np.argsort(ts, kind="stable")][:max_scatterers]
            n = len(idx)
            # The recording's sensor-frame range is the vehicle-frame
            # distance (tests/test_cli_dataset.py), as the loader reads it.
            cols["range_m"][f, b, :n] = r_v[idx]
            cols["azimuth_rad"][f, b, :n] = az_s[idx]
            cols["rcs_db"][f, b, :n] = rcs[idx]
            cols["vr"][f, b, :n] = vr[idx]
            valid[f, b, :n] = True
    cols["valid"] = valid
    return cols, mounts
