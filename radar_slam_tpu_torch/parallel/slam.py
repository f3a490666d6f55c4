"""Trajectory refinement: odometry chain + loop closures -> pose-graph GN.

Counterpart of ``radar_slam_tpu/parallel/slam.py`` in one process: the
per-frame velocity solves become odometry factors
(``posegraph.from_velocities``), scan matching adds loop-closure factors
(``loopclosure.find_loop_closures`` or
``scancontext.find_loop_closures_sc``), and Gauss-Newton
(``ba.gauss_newton_cg``, or ``ba.schur_gn_step`` over ``n_blocks`` keyframe
blocks) refines the trajectory.  The graph and the point clouds live on
the device of the point clouds (or ``device``); the proposers' candidate
lists and the loop weights are the reference's host numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.parallel import ba, posegraph
from radar_slam_tpu_torch.parallel.loopclosure import (LoopClosureConfig,
                                                       find_loop_closures)
from radar_slam_tpu_torch.utils.host import device_get


def targets_to_points(range_m: np.ndarray, azimuth_rad: np.ndarray,
                      valid: np.ndarray, device=DEFAULT):
    """Per-frame body-frame detection positions [F, K, 2] + mask, as
    tensors on ``device``."""
    x = np.asarray(range_m) * np.cos(np.asarray(azimuth_rad))
    y = np.asarray(range_m) * np.sin(np.asarray(azimuth_rad))
    dev = resolve(device)
    return (torch.as_tensor(np.stack([x, y], axis=-1), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.asarray(valid), device=dev))


def refine_sequence_output(out, dt: float,
                           lc_cfg: LoopClosureConfig = LoopClosureConfig(),
                           n_blocks: int = 1, solver: str = "cg",
                           proposer: str = "pose",
                           use_z: bool = False) -> Dict:
    """Refine a pipeline ``FrameOutput`` sequence (any driver) with
    loop-closure pose-graph GN on the device of its target clouds
    (``target_xy`` / ``target_valid``); ``use_z`` feeds the solver's
    vertical rate into the z-aware graph."""
    vel, w, ok = device_get((out.motion.velocity,
                             out.motion.angular_velocity,
                             out.motion.success))
    return refine_trajectory(
        vel, w[:, 2], ok, dt,
        frame_points=out.target_xy, frame_valid=out.target_valid,
        lc_cfg=lc_cfg, n_blocks=n_blocks, solver=solver, proposer=proposer,
        use_z=use_z)


def propose_weighted_loops(frame_points, frame_valid, open_poses,
                           lc_cfg: LoopClosureConfig = LoopClosureConfig(),
                           proposer: str = "pose"):
    """Retrieve loop-closure candidates for ONE sequence and convert each
    into a weighted factor.

    Returns (raw candidate dicts, [(i, j, delta [3], info [3]), ...])."""
    F = len(open_poses)
    if proposer == "scancontext":
        from radar_slam_tpu_torch.parallel.scancontext import (
            find_loop_closures_sc)
        loops = find_loop_closures_sc(frame_points, frame_valid,
                                      open_poses[:F], lc_cfg)
    elif proposer == "pose":
        loops = find_loop_closures(frame_points, frame_valid,
                                   open_poses[:F], lc_cfg)
    else:
        raise ValueError(f"Unknown loop-closure proposer: {proposer}")
    # Lever arm for the angular information: a yaw error d_theta moves a
    # point at radius r by r*d_theta, so the registration's positional
    # variance maps to an angular variance of var / r_bar^2 (r_bar = mean
    # radius of the loop frame's valid points).  Only the loops' frames are
    # fetched.
    js = torch.as_tensor([lc["j"] for lc in loops], dtype=torch.long,
                         device=frame_points.device)
    pv, pts = device_get((frame_valid[js], frame_points[js]))
    pr = np.linalg.norm(pts, axis=-1)
    weighted = []
    for k, lc in enumerate(loops):
        # Information from the ICP fit quality: var ~ rmse^2 / inliers,
        # capped at info_scale.
        var = max(lc["rmse"] ** 2 / max(lc["inliers"], 1),
                  1.0 / lc_cfg.info_scale)
        vj = pv[k]
        r_bar = float(pr[k][vj].mean()) if vj.any() else 1.0
        var_theta = max(var / max(r_bar, 1.0) ** 2,
                        1.0 / lc_cfg.info_scale)
        info = np.array([1.0 / var, 1.0 / var, 1.0 / var_theta],
                        np.float32)
        weighted.append((lc["i"], lc["j"], np.asarray(lc["delta"]), info))
    return loops, weighted


def refine_trajectory(velocities, yaw_rates, success, dt: float,
                      frame_points: Optional[torch.Tensor] = None,
                      frame_valid: Optional[torch.Tensor] = None,
                      lc_cfg: LoopClosureConfig = LoopClosureConfig(),
                      n_blocks: int = 1, gn_iters: int = 10,
                      cg_iters: int = 60, solver: str = "cg",
                      proposer: str = "pose", use_z: bool = False,
                      device=None) -> Dict:
    """Build + solve the pose graph for one sequence.

    Args:
        velocities: [F, 3] per-frame body velocities (from the solver).
        yaw_rates: [F].
        success: [F] bool.
        frame_points / frame_valid: [F, K, 2] / [F, K] detection positions
            for loop-closure scan matching (None disables loop closures).
        solver: "cg" -- GN with CG inner solves (``ba.gauss_newton_cg``);
            "schur" -- iterated keyframe-block Schur elimination with the
            Woodbury loop correction (``ba.schur_gn_step`` over
            ``n_blocks`` blocks).  Keyframes are padded with weak
            zero-motion factors to a multiple of ``n_blocks``.
        proposer: "pose" -- revisit candidates gated on the open-loop pose
            estimates; "scancontext" -- descriptor retrieval independent of
            odometric drift.
        use_z: optimize the z-aware (x, y, z, yaw) graph, consuming
            ``velocities[:, 2]``.  Loop closures stay planar; their z
            component enters as a zero-delta row at 1% of the xy
            information.
        device: where the graph lives; default the device of
            ``frame_points``, else the card.

    Returns dict with open-loop poses [F+1, D], refined poses [F+1, D]
    (host numpy), accepted loop closures, the final graph cost and the
    graph at the refined poses.
    """
    if device is None:
        device = (frame_points.device if frame_points is not None
                  else resolve(DEFAULT))
    velocities, yaw_rates, success = device_get((velocities, yaw_rates,
                                                 success))
    F = len(velocities)
    velocities = np.asarray(velocities, np.float32)
    yaw_rates = np.asarray(yaw_rates, np.float32)
    success = np.asarray(success, bool)
    if solver == "schur":
        n_poses = -(-(F + 1) // n_blocks) * n_blocks
        pad = n_poses - 1 - F
        if pad:
            velocities = np.concatenate(
                [velocities, np.zeros((pad, 3), np.float32)])
            yaw_rates = np.concatenate(
                [yaw_rates, np.zeros(pad, np.float32)])
            success = np.concatenate([success, np.zeros(pad, bool)])
    elif solver != "cg":
        raise ValueError(f"Unknown pose-graph solver: {solver}")

    def up(x):
        return torch.as_tensor(x, device=device)

    cap = lc_cfg.max_candidates if frame_points is not None else 1
    graph = posegraph.from_velocities(
        up(velocities), up(yaw_rates), up(success), dt, loop_capacity=cap,
        use_z=use_z)
    open_poses = device_get(graph.poses)

    loops = []
    if frame_points is not None:
        lc_poses = (open_poses[:F][:, [0, 1, 3]] if use_z
                    else open_poses[:F])
        loops, weighted = propose_weighted_loops(
            frame_points, frame_valid, lc_poses, lc_cfg, proposer)
        for slot, (i, j, delta, info) in enumerate(weighted[:cap]):
            delta = np.asarray(delta, np.float32)
            if use_z:
                delta = np.array([delta[0], delta[1], 0.0, delta[2]],
                                 np.float32)
                info = np.array([info[0], info[1], 0.01 * info[0],
                                 info[2]], np.float32)
            graph = posegraph.add_loop_closure(graph, slot, i, j, delta,
                                               info)

    if solver == "schur":
        poses = graph.poses
        for _ in range(gn_iters):
            poses = ba.schur_gn_step(graph._replace(poses=poses), n_blocks)
        cost = posegraph.total_cost(poses, graph)
    else:
        poses, cost = ba.gauss_newton_cg(graph, gn_iters=gn_iters,
                                         cg_iters=cg_iters)
    return {
        "open_loop_poses": open_poses[:F + 1],
        "poses": device_get(poses)[:F + 1],
        "loop_closures": loops,
        "cost": float(cost),
        "graph": graph._replace(poses=poses),
    }
