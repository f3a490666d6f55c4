#!/usr/bin/env python3
"""What the six-step artifact pipeline reaches on the CLI's synthetic scene,
in the JAX reference and in the PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/artifact_pipeline_reference.py \
        [--frames 64] [--seeds 0,1,2]

Runs ``EgoMotionPipeline.run_complete_pipeline`` of each package at the
``pipeline`` subcommand's configuration (``complete_analysis_config()``,
``max_scatterers=512``, MUSIC) on the scene it builds (seed 7, 96 points,
v_body (8.0, 0.5) m/s, yaw rate 0.05 rad/s), without artifacts, for each
synthesis seed.  Prints one JSON line per package and seed: solve success
over frames 1.., the largest and the RMS velocity error per component of
the successful frames 1.. against the truth, the number of those frames
off by more than 0.3 m/s in vx or vy (the gate ``chip_smoke.py`` sets),
and the final position.  The noise bits of the two packages differ (their
PRNGs do), so their numbers are two realizations of one scene.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def summary(label, seed, vel, success, pos):
    v = np.asarray(vel, np.float64)[1:]
    ok = np.asarray(success, bool)[1:]
    err = v[ok, :2] - np.array([8.0, 0.5])
    return {"package": label, "seed": seed, "frames": len(vel),
            "success": float(ok.mean()),
            "max_abs_err_vx_vy": np.abs(err).max(axis=0).tolist(),
            "rms_err_vx_vy": np.sqrt((err ** 2).mean(axis=0)).tolist(),
            "frames_over_0.3": int((np.abs(err) > 0.3).any(axis=1).sum()),
            "final_position": np.asarray(pos, np.float64)[-1].tolist()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--seeds", default="0")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline.pipeline import EgoMotionPipeline as JaxPipe
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    from radar_slam_tpu_torch.pipeline.pipeline import (
        EgoMotionPipeline as TorchPipe)

    jax.config.update("jax_platforms", "cpu")
    cfg = complete_analysis_config()
    cfg = dataclasses.replace(cfg, aoa=dataclasses.replace(cfg.aoa,
                                                           method="music"))
    batch, _ = constant_motion_scene(
        7, num_frames=args.frames, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05, scene=SceneConfig(num_points=96,
                                         max_scatterers=cfg.max_scatterers))
    fields = {k: np.asarray(v) for k, v in batch._asdict().items()
              if v is not None}
    tbatch = scatterer_batch_from_numpy(fields, "cpu")
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    with tempfile.TemporaryDirectory() as tmp:
        for seed in (int(s) for s in args.seeds.split(",")):
            jp = JaxPipe(cfg, tmp, save_artifacts=False)
            jp.run_complete_pipeline(batch, seed=seed)
            print(json.dumps(summary(
                "jax", seed, jp._motions.velocity, jp._motions.success,
                jp._trajectory.positions)), flush=True)
            tp = TorchPipe(tcfg, tmp, save_artifacts=False, device="cpu")
            tp.run_complete_pipeline(tbatch, seed=seed)
            print(json.dumps(summary(
                "torch", seed, tp._motions.velocity, tp._motions.success,
                tp._trajectory.positions)), flush=True)


if __name__ == "__main__":
    main()
