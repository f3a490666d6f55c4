"""Multi-sequence batch processing: sequences partitioned across ranks.

Counterpart of ``radar_slam_tpu/parallel/multiseq.py`` (BASELINE.json
config 5, "multi-sequence RadarScenes batch").  The sequence axis [M] is
written out, as the rig driver writes out its sensors:

- **across sequences** (:func:`process_sequences_sharded`): rank r takes
  the contiguous block of M / n sequences and runs the whole pipeline and
  the pose-graph GN for it.  Its phase A is ONE front-end launch over its
  M_r * F frames (K1 on the one-pass route: the reference's vmap of
  ``process_sequence_batched``), phase B loops over its sequences, and
  their graphs are solved as one stacked GN-CG (``ba.gauss_newton_cg`` on
  a graph [M_r, ...]).  No collective but the final gather.
- **composed** (:func:`solve_graphs_mesh`, :func:`process_sequences_schur`,
  :func:`refine_sequences_mesh`): the sequences' graphs also need the
  distributed solver.  The pipeline phase stays sequence-sharded; the
  solve phase loops the sequences through the ranked Schur step
  (``ba.schur_gn_step(mesh=...)``), every graph's poses split across all
  ranks (loop closures enter through the Woodbury correction).

Seeds: sequence m's frame seeds come from ``generators[m]`` as
``process_sequence_batched(scatterers[m], generators[m], cfg)`` draws
them, so each sequence's outputs equal that driver's.  Each rank draws
only from its own sequences' generators.  Every function returns the
whole batch [M, ...] on every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.types import FrameOutput, ScattererBatch
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.noise import frame_seeds
from radar_slam_tpu_torch.parallel import ba, posegraph
from radar_slam_tpu_torch.parallel.dp import _block_features_scatterers
from radar_slam_tpu_torch.parallel.mesh import Mesh
from radar_slam_tpu_torch.pipeline import frame as frame_mod
from radar_slam_tpu_torch.utils.host import (device_get, tree_leaves,
                                             tree_map, tree_unflatten)


def _stack(trees: List):
    """Trees of equal structure stacked leaf by leaf on a new axis 0."""
    return tree_unflatten(trees[0], [torch.stack(xs) for xs in
                                     zip(*map(tree_leaves, trees))])


def _unstack(tree, m: int):
    return tree_map(lambda x: x[m], tree)


def _pipeline_block(scatterers: ScattererBatch,
                    generators: Sequence[torch.Generator],
                    cfg: PipelineConfig, mesh: Mesh) -> FrameOutput:
    """This rank's sequences through ``process_sequence_batched``'s two
    phases: phase A once over the block's M_r * F frames, phase B per
    sequence.  Returns a FrameOutput [M_r, F, ...]."""
    frame_mod._check_supported(cfg)
    fe.use_f32_matmuls()
    M, F = scatterers.range_m.shape[:2]
    rows = mesh.block(M)
    block = mesh.take(scatterers)
    Mr = block.range_m.shape[0]
    dev = block.range_m.device
    seeds = torch.cat([frame_seeds(g, F, dev) for g in generators[rows]])
    flat = tree_map(lambda x: x.reshape((Mr * F,) + x.shape[2:]), block)
    features = _block_features_scatterers(flat, seeds, cfg)
    return _stack([frame_mod._sequence_from_features(
        tree_map(lambda x: x[m * F:(m + 1) * F], features), cfg, True)
        for m in range(Mr)])


def _graphs(out: FrameOutput, dt: float, loop_capacity: int
            ) -> posegraph.PoseGraph:
    """The odometry graph of every sequence of ``out`` [M, F, ...],
    stacked [M, ...]."""
    return _stack([posegraph.from_velocities(
        out.motion.velocity[m], out.motion.angular_velocity[m, :, 2],
        out.motion.success[m], dt, loop_capacity=loop_capacity)
        for m in range(out.motion.success.shape[0])])


def process_sequences_sharded(scatterers: ScattererBatch,
                              generators: Sequence[torch.Generator],
                              cfg: PipelineConfig, mesh: Mesh,
                              gn_iters: int = 6, cg_iters: int = 40
                              ) -> Tuple[FrameOutput, torch.Tensor,
                                         torch.Tensor]:
    """Full pipeline + pose-graph GN for a batch of sequences, sequence-
    sharded over the mesh.

    Args:
        scatterers: stacked [M, F, S] scatterers (M a multiple of the mesh
            size).
        generators: M generators, sequence m's noise seeds.

    Returns (per-frame outputs [M, F, ...], refined poses [M, F+1, 3],
    costs [M])."""
    out = _pipeline_block(scatterers, generators, cfg, mesh)
    poses, costs = ba.gauss_newton_cg(_graphs(out, cfg.frame_dt, 1),
                                      gn_iters=gn_iters, cg_iters=cg_iters)
    return mesh.gather((out, poses, costs))


def solve_graphs_mesh(graphs: posegraph.PoseGraph, mesh: Mesh,
                      n_chain: Optional[int] = None, steps: int = 8,
                      damping: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve a stacked batch of pose graphs [M, ...] with the ranked
    keyframe-block Schur solver, the sequences one after another (the
    reference's ``lax.scan``): each graph's poses split across all ranks.

    Pose count N must be a multiple of the mesh size; all sequences share
    one factor layout (``n_chain`` leading chain slots, the rest loop
    slots, valid or not).  Returns (poses [M, N, D], costs [M])."""
    poses_out, costs = [], []
    for m in range(graphs.poses.shape[0]):
        g = _unstack(graphs, m)
        poses = g.poses
        for _ in range(steps):
            poses = ba.schur_gn_step(g._replace(poses=poses), mesh=mesh,
                                     damping=damping, n_chain=n_chain)
        poses_out.append(poses)
        costs.append(posegraph.total_cost(poses, g))
    return torch.stack(poses_out), torch.stack(costs)


def _check_keyframe_blocks(F: int, mesh: Mesh) -> None:
    if (F + 1) % mesh.size:
        raise ValueError(f"(F + 1) = {F + 1} must divide the mesh size "
                         f"{mesh.size} into keyframe blocks")


def process_sequences_schur(scatterers: ScattererBatch,
                            generators: Sequence[torch.Generator],
                            cfg: PipelineConfig, mesh: Mesh, steps: int = 8,
                            loop_capacity: int = 1
                            ) -> Tuple[FrameOutput, torch.Tensor,
                                       torch.Tensor]:
    """Config 5 end to end: the sequence-sharded pipeline phase of
    :func:`process_sequences_sharded`, then every sequence's graph through
    the ranked Schur solver (:func:`solve_graphs_mesh`).  (F + 1) must be
    a multiple of the mesh size.  Loop slots stay empty (open-loop
    refinement); :func:`refine_sequences_mesh` fills them.

    Returns (per-frame outputs [M, F, ...], refined poses [M, F+1, 3],
    costs [M])."""
    _check_keyframe_blocks(scatterers.range_m.shape[1], mesh)
    out = mesh.gather(_pipeline_block(scatterers, generators, cfg, mesh))
    poses, costs = solve_graphs_mesh(
        _graphs(out, cfg.frame_dt, loop_capacity), mesh, steps=steps)
    return out, poses, costs


def refine_sequences_mesh(scatterers: Optional[ScattererBatch],
                          generators: Optional[Sequence[torch.Generator]],
                          cfg: PipelineConfig, mesh: Mesh, steps: int = 8,
                          loop_capacity: int = 4, lc_cfg=None,
                          proposer: str = "scancontext",
                          out: Optional[FrameOutput] = None):
    """Config 5's loop-closure round trip: sharded pipeline -> per-sequence
    loop retrieval (scan context or the pose gate, then ICP) -> fill the
    stacked graphs' loop slots -> the ranked Schur solve.

    Retrieval is host-side control flow on the gathered outputs; every
    rank runs it on the same data and so fills the same slots.

    Args:
        scatterers: stacked [M, F, S] scatterers; (F + 1) must be a
            multiple of the mesh size (keyframe blocks).
        generators: M generators, sequence m's noise seeds.
        loop_capacity: loop slots per graph (extra retrievals dropped).
        proposer: "scancontext" or "pose".
        out: precomputed pipeline outputs [M, F, ...] -- skips the
            pipeline phase.

    Returns (per-frame outputs [M, F, ...], refined poses [M, F+1, 3],
    costs [M], accepted loop lists per sequence)."""
    from radar_slam_tpu_torch.parallel import slam
    from radar_slam_tpu_torch.parallel.loopclosure import LoopClosureConfig

    if lc_cfg is None:
        lc_cfg = LoopClosureConfig()
    M, F = (out.motion.success.shape if out is not None
            else scatterers.range_m.shape[:2])
    _check_keyframe_blocks(F, mesh)
    if out is None:
        out = mesh.gather(_pipeline_block(scatterers, generators, cfg, mesh))
    graphs = _graphs(out, cfg.frame_dt, max(loop_capacity, 1))

    # Host-side retrieval + slot fill (numpy on the small graph arrays).
    open_poses, fi, fj, delta, info, valid = (
        np.array(x) for x in device_get((graphs.poses, graphs.fi, graphs.fj,
                                         graphs.delta, graphs.info,
                                         graphs.factor_valid)))
    all_loops = []
    for m in range(M):
        loops, weighted = slam.propose_weighted_loops(
            out.target_xy[m], out.target_valid[m], open_poses[m, :F],
            lc_cfg, proposer)
        all_loops.append(loops[:loop_capacity])
        for slot, (i, j, dlt, w) in enumerate(weighted[:loop_capacity]):
            k = F + slot                      # slots sit after the chain
            fi[m, k], fj[m, k] = i, j
            delta[m, k] = np.asarray(dlt)
            info[m, k] = np.asarray(w)
            valid[m, k] = True

    def up(x):
        return torch.as_tensor(x, device=graphs.poses.device)

    graphs = graphs._replace(fi=up(fi), fj=up(fj), delta=up(delta),
                             info=up(info), factor_valid=up(valid))
    poses, costs = solve_graphs_mesh(graphs, mesh, steps=steps)
    return out, poses, costs, all_loops
