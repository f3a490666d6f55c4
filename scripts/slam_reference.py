#!/usr/bin/env python3
"""What ``analyze --slam`` reaches at depth, in the JAX reference and in the
PyTorch port, on the same front-end output.

    python scripts/slam_reference.py frontend [--frames 2048]   # on a card
    JAX_PLATFORMS=cpu python scripts/slam_reference.py refine   # on the CPU
    python scripts/slam_reference.py precision                  # on the CPU

``frontend`` builds the scene of ``chip_smoke.py``'s ``slam_deep`` phase --
the CLI's synthetic scene (``constant_motion_scene`` seed 7, v_body (8.0,
0.5) m/s, yaw rate 0.05 rad/s, ``complete_analysis_config()`` with
``max_scatterers=512``) at ``--frames`` frames with ``num_points`` scaled
with the path, 96 x frames / 64, so each frame sees the density of the
CLI's 64-frame scene -- and runs the port's ``process_sequence_batched``
on it once (generator seed 0, K1 on a card), twice with ``--repeat 2`` to
check that the front end repeats bit for bit.  It saves the velocities,
yaw rates, success, target clouds and ground-truth poses, with a SHA-256
digest of them, to ``--out`` (default
``chiprun_out/slam_deep_inputs.npz``).  It imports nothing of JAX.

``refine`` feeds those arrays to both packages' ``refine_trajectory`` on
the CPU -- (cg, pose), (cg, scancontext) and (schur, scancontext), the
Schur solver on ``make_mesh(1)`` in the reference and over one block in
the port, the CLI's form -- and prints one JSON line per run: open-loop and
refined position / yaw RMSE against the ground truth (the CLI's
``planar_pose_errors`` of poses 1..F), the accepted loops (i, j), the
largest pose difference between the packages, and each package's wall
time.  The lines also go to ``--json`` (default
``chiprun_out/slam_reference.json``).

``precision`` runs the port's Schur step (one block, 10 steps) on the
(schur, scancontext) graph of the same arrays in float32 and in float64,
on the CPU, and prints each step's cost and the final RMSE: whether a
divergence is the float32 arithmetic's or the Gauss-Newton iteration's.
"""

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FIELDS = ("velocity", "yaw_rate", "success", "target_xy", "target_valid")
RUNS = (("cg", "pose"), ("cg", "scancontext"), ("schur", "scancontext"))


def digest(arrays):
    """SHA-256 of the front-end arrays, in FIELDS order."""
    h = hashlib.sha256()
    for k in FIELDS:
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def deep_scene(frames, device, world_frames=None):
    """(batch, ground truth, config) of the slam_deep scene:
    ``constant_motion_scene``'s path and world (its numpy core: the
    constant-twist path, ``corridor_points``, ``observe_points``) with
    ``num_points`` = 96 x world_frames / 64, the world laid along the
    first ``world_frames`` (default ``frames``) frames of the path; later
    frames drive on around the same circle through the same world.  That
    builder gives every world point a slot in every frame, which 3,072
    points cannot have in 512 slots, so each frame observes only the
    points within max_range + 1 m of the ego (the others are outside its
    range gate anyway): the same observable points, in fewer slots."""
    from radar_slam_tpu_torch.core.config import complete_analysis_config
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                                   corridor_points,
                                                   observe_points)
    cfg = complete_analysis_config()
    world_frames = world_frames or frames
    scene = SceneConfig(num_points=96 * world_frames // 64,
                        max_scatterers=cfg.max_scatterers)
    dt, w = cfg.frame_dt, 0.05
    vb = np.array([8.0, 0.5], np.float64)
    yaws = w * dt * np.arange(frames + 1)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1]],
                     axis=-1) * dt
    path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)])
    world, rcs = corridor_points(7, scene, path[:world_frames + 1])
    cols = []
    for i in range(frames):
        d = np.asarray(world, np.float64) - path[i]
        near = np.nonzero(np.hypot(d[:, 0], d[:, 1])
                          <= scene.max_range + 1.0)[0]
        cols.append(observe_points(world[near], rcs[near], path[i], yaws[i],
                                   vb, w, scene.max_scatterers,
                                   max_range=scene.max_range,
                                   fov_rad=scene.fov_rad))
    stack = {k: np.stack([f[k] for f in cols]) for k in cols[0]}
    gt = {"poses": np.concatenate([path[:frames], yaws[:frames, None]],
                                  axis=-1)}
    return scatterer_batch_from_numpy(stack, device), gt, cfg


def frontend_arrays(out):
    """The refinement's inputs from a FrameOutput, as numpy."""
    from radar_slam_tpu_torch.utils.host import device_get
    vel, w, ok, xy, valid = device_get((
        out.motion.velocity, out.motion.angular_velocity,
        out.motion.success, out.target_xy, out.target_valid))
    return {"velocity": vel, "yaw_rate": w[:, 2], "success": ok,
            "target_xy": xy, "target_valid": valid}


def cmd_frontend(args):
    import torch
    from radar_slam_tpu_torch.pipeline.frame import process_sequence_batched

    device = torch.device(args.device)
    batch, gt, cfg = deep_scene(args.frames, device)
    digests = []
    for _ in range(args.repeat):
        out = process_sequence_batched(
            batch, torch.Generator().manual_seed(0), cfg)
        arrays = frontend_arrays(out)
        digests.append(digest(arrays))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, poses=np.asarray(gt["poses"]),
                        dt=cfg.frame_dt, **arrays)
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"frames": args.frames, "device": name,
                      "digests": digests,
                      "repeats_bit_for_bit": len(set(digests)) == 1,
                      "success": float(arrays["success"].mean()),
                      "valid_targets_per_frame": float(
                          arrays["target_valid"].sum(1).mean()),
                      "out": args.out}))


def rmse(poses, gt):
    from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
    F = len(gt)
    m = planar_pose_errors(np.asarray(poses)[1:F + 1], gt)
    return m["position_rmse"], m["yaw_rmse"]


def cmd_refine(args):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from radar_slam_tpu.parallel import slam as jslam
    from radar_slam_tpu.parallel.mesh import make_mesh
    from radar_slam_tpu_torch.parallel import slam as tslam

    d = np.load(args.inputs)
    a = {k: d[k] for k in FIELDS}
    gt, dt = d["poses"], float(d["dt"])
    common = (a["velocity"], a["yaw_rate"], a["success"], dt)
    lines = []
    for solver, proposer in RUNS:
        t0 = time.perf_counter()
        ref = jslam.refine_trajectory(
            *common, frame_points=jnp.asarray(a["target_xy"]),
            frame_valid=jnp.asarray(a["target_valid"]), solver=solver,
            proposer=proposer,
            mesh=make_mesh(1) if solver == "schur" else None)
        t1 = time.perf_counter()
        port = tslam.refine_trajectory(
            *common, frame_points=torch.from_numpy(a["target_xy"]),
            frame_valid=torch.from_numpy(a["target_valid"]), solver=solver,
            proposer=proposer, n_blocks=1, device="cpu")
        t2 = time.perf_counter()
        line = {"solver": solver, "proposer": proposer,
                "frames": len(gt), "inputs": digest(a)}
        for name, res in (("jax", ref), ("port", port)):
            line[name] = {
                "open_loop_rmse": rmse(res["open_loop_poses"], gt),
                "refined_rmse": rmse(res["poses"], gt),
                "loops": [(lc["i"], lc["j"])
                          for lc in res["loop_closures"]],
                "cost": res["cost"]}
        diff = np.asarray(port["poses"]) - np.asarray(ref["poses"])
        line["max_pose_diff_xy"] = float(np.abs(diff[:, :-1]).max())
        line["max_pose_diff_yaw"] = float(np.abs(np.angle(
            np.exp(1j * diff[:, -1]))).max())
        line["wall_s"] = {"jax": t1 - t0, "port": t2 - t1}
        print(json.dumps(line), flush=True)
        lines.append(line)
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text("\n".join(json.dumps(x) for x in lines)
                               + "\n")


def cmd_precision(args):
    import torch
    from radar_slam_tpu_torch.parallel import ba, posegraph
    from radar_slam_tpu_torch.parallel import slam as tslam

    d = np.load(args.inputs)
    gt = d["poses"]
    res = tslam.refine_trajectory(
        d["velocity"], d["yaw_rate"], d["success"], float(d["dt"]),
        frame_points=torch.from_numpy(d["target_xy"]),
        frame_valid=torch.from_numpy(d["target_valid"]), solver="schur",
        proposer="scancontext", gn_iters=0, device="cpu")
    for dtype in (torch.float32, torch.float64):
        g = res["graph"]._replace(**{
            k: v.to(dtype) for k, v in res["graph"]._asdict().items()
            if v.is_floating_point()})
        poses, costs = g.poses, []
        for _ in range(10):
            poses = ba.schur_gn_step(g._replace(poses=poses), 1)
            costs.append(float(posegraph.total_cost(poses, g)))
        p = poses.to(torch.float32).numpy()
        print(json.dumps({"dtype": str(dtype), "loops": len(
            res["loop_closures"]), "costs": costs,
            "refined_rmse": rmse(p, gt) if np.isfinite(p).all() else None}))


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("frontend")
    f.add_argument("--frames", type=int, default=2048)
    f.add_argument("--device", default="cuda")
    f.add_argument("--repeat", type=int, default=1)
    f.add_argument("--out", default="chiprun_out/slam_deep_inputs.npz")
    r = sub.add_parser("refine")
    r.add_argument("--inputs", default="chiprun_out/slam_deep_inputs.npz")
    r.add_argument("--json", default="chiprun_out/slam_reference.json")
    q = sub.add_parser("precision")
    q.add_argument("--inputs", default="chiprun_out/slam_deep_inputs.npz")
    args = ap.parse_args()
    {"frontend": cmd_frontend, "refine": cmd_refine,
     "precision": cmd_precision}[args.cmd](args)


if __name__ == "__main__":
    main()
