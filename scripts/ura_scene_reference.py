#!/usr/bin/env python3
"""What the 3-D scene of ``tests/test_elevation.py`` reaches with a URA and
with a ULA, in the JAX reference and in the PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ura_scene_reference.py [--seeds 0]

The configuration is that test's CFG: an 8 x 4 URA (A = 32) at 32 chirps,
``noise_power=1e-6``, ``threshold_db=-10``, the AoA grid 1.0 deg in azimuth
and -45..45 deg at 1.5 deg in elevation, ``z_velocity_weight=1.0``; the
scene is seed 31, v_body (8.0, 0.5, 1.0) m/s, yaw rate 0.05 rad/s, 48
points, z_span 5.0 m, 10 frames.  The reference runs ``process_sequence``
on its own CPU route (synthesized cubes, the FFT RDS: the route of
``test_vz_recovery_with_ura``); the port runs ``process_sequence`` and
``process_sequence_batched`` at ``fft_mode="fused"``, ``synth_in_kernel``
(the one-pass front end, K1's plain version here).  Each also runs the
ULA control (``num_antennas_el=1``).  Prints one JSON line per package,
driver and array: the largest |v_x - 8.0| and |v_z - 1.0| and the largest
|v_z| over frames 1..9, against the reference's test gates (URA: 0.4 and
0.4; ULA: |v_z| < 0.5, v_x within 0.5).  The two packages' noise bits
differ (their PRNGs do), so their numbers are two realizations.
"""

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def summary(package, driver, array, seed, vel):
    v = np.asarray(vel, np.float64)[1:]
    return {"package": package, "driver": driver, "array": array,
            "seed": seed,
            "max_abs_err_vx": float(np.abs(v[:, 0] - 8.0).max()),
            "max_abs_err_vz": float(np.abs(v[:, 2] - 1.0).max()),
            "max_abs_vz": float(np.abs(v[:, 2]).max()),
            "mean_v": v.mean(axis=0).tolist()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from radar_slam_tpu.core.config import (AoAConfig, DetectionConfig,
                                            PipelineConfig, RadarConfig,
                                            VelocityConfig)
    from radar_slam_tpu.io.synthetic import (SceneConfig,
                                             constant_motion_scene_3d)
    from radar_slam_tpu.pipeline import frame as jframe
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    from radar_slam_tpu_torch.pipeline import frame as tframe

    ura = RadarConfig(num_chirps=32, num_antennas=8, num_antennas_el=4,
                      noise_power=1e-6)
    cfg = PipelineConfig(
        radar=ura,
        detection=DetectionConfig(threshold_db=-10.0, max_detections=64),
        aoa=AoAConfig(search_resolution_deg=1.0, el_min_deg=-45.0,
                      el_max_deg=45.0, el_resolution_deg=1.5,
                      confidence_threshold=0.5, max_targets=50,
                      track_capacity=64),
        velocity=VelocityConfig(z_velocity_weight=1.0))
    batch, _ = constant_motion_scene_3d(
        31, num_frames=10, dt=cfg.frame_dt, v_body=(8.0, 0.5, 1.0),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=48, max_scatterers=cfg.max_scatterers),
        z_span=5.0)
    fields = {k: np.asarray(v) for k, v in batch._asdict().items()
              if v is not None}
    tbatch = scatterer_batch_from_numpy(fields, "cpu")
    for array, el in (("ura", 4), ("ula", 1)):
        c = dataclasses.replace(cfg, radar=dataclasses.replace(
            ura, num_antennas_el=el))
        tc = dataclasses.replace(config_from_dict(dataclasses.asdict(c)),
                                 fft_mode="fused", synth_in_kernel=True)
        for seed in (int(s) for s in args.seeds.split(",")):
            out = jframe.process_sequence(batch, jax.random.key(seed), c)
            print(json.dumps(summary("jax", "process_sequence", array, seed,
                                     out.motion.velocity)), flush=True)
            for name in ("process_sequence", "process_sequence_batched"):
                out = getattr(tframe, name)(
                    tbatch, torch.Generator().manual_seed(seed), tc)
                print(json.dumps(summary(
                    "torch one-pass", name, array, seed,
                    out.motion.velocity.numpy())), flush=True)


if __name__ == "__main__":
    main()
