#!/usr/bin/env python3
"""What the 64-frame bench scene reaches at a chirp subset, in the JAX
reference and in the PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/chirp_subset_reference.py \
        [--subset 0,16] [--seeds 0,1] [--frames 64]

The bench operating point (``complete_analysis_config()``,
``max_scatterers=128``) with ``chirp_subset`` set, on the bench scene
(seed 7, 96 points, v_body (8.0, 0.5) m/s, yaw rate 0.05 rad/s).  Each
package synthesizes its own noisy cubes (the reference with
``jax.random.key(seed)``, the port with ``torch.Generator().manual_seed
(seed)``: two realizations) and runs its ``process_signal_sequence_batched``
(the fused power map).  Prints one JSON line per package and seed: solve
success over frames 1.., the final pose error and the position RMSE, beside
the same at all 32 chirps.
"""

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subset", default="0,16")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as jframe
    from radar_slam_tpu.signal.synth import synthesize_frames_batch as jsynth
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu_torch.pipeline import frame as tframe
    from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch

    subset = tuple(int(c) for c in args.subset.split(","))
    base = dataclasses.replace(complete_analysis_config(), max_scatterers=128)
    batch, gt = constant_motion_scene(
        7, num_frames=args.frames, dt=base.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05, scene=SceneConfig(num_points=96, max_scatterers=128))
    fields = {k: np.asarray(v) for k, v in batch._asdict().items()
              if v is not None}
    tbatch = scatterer_batch_from_numpy(fields, "cpu")

    def summary(package, chirps, seed, pose, success):
        pose = np.asarray(pose, np.float64)
        return {"package": package, "chirps": chirps, "seed": seed,
                "success": float(np.asarray(success)[1:].mean()),
                "final_pose_err_m": float(np.linalg.norm(
                    pose[-1, :2] - gt["poses"][-1, :2])),
                "pos_rmse_m": float(planar_pose_errors(
                    pose, gt["poses"])["position_rmse"])}

    for seed in (int(s) for s in args.seeds.split(",")):
        jsig = jsynth(batch, base.radar, jax.random.key(seed))
        tsig = synthesize_frames_batch(tbatch, config_from_dict(
            dataclasses.asdict(base)).radar,
            torch.Generator().manual_seed(seed))
        for chirps in (None, subset):
            cfg = dataclasses.replace(base, chirp_subset=chirps)
            label = "all" if chirps is None else list(chirps)
            out = jframe.process_signal_sequence_batched(jnp.asarray(jsig),
                                                         cfg)
            print(json.dumps(summary("jax", label, seed, out.pose,
                                     out.motion.success)), flush=True)
            out = tframe.process_signal_sequence_batched(
                tsig, config_from_dict(dataclasses.asdict(cfg)))
            print(json.dumps(summary("torch", label, seed,
                                     out.pose.numpy(),
                                     out.motion.success.numpy())),
                  flush=True)


if __name__ == "__main__":
    main()
