"""Gauss-Newton for the pose graph: CG inner solves and the Schur step.

Counterpart of ``radar_slam_tpu/parallel/ba.py``.  Two solvers, both
generic over the pose dimension (planar (x, y, yaw) or z-aware (x, y, z,
yaw), ``posegraph.py``), and both SPMD over a mesh of ranks
(``mesh.py``) with the pose vector replicated:

- :func:`gauss_newton_cg` -- GN with a Jacobi-preconditioned CG inner
  solve.  It runs a fixed ``gn_iters x cg_iters`` with the reference's
  ``1e-30`` guards and no early exit, so nothing in it waits on the device
  (one host read of the factor endpoints before it, :func:`_incidence`;
  under gloo every collective is a host round trip of its own).  The
  Jacobians and weights depend only on the poses: they are computed once
  per GN iteration (:func:`_linearize`) and reused by every Hessian-vector
  product, whose sums over factors run in a fixed order, so a solve
  repeats bit for bit.  On a mesh each rank takes a contiguous block of
  the factor axis and the gradient, diagonal and products are summed over
  the ranks (the reference's ``psum``).  A stacked graph [M, ...] (every
  field with a leading sequence axis, as ``multiseq.py`` builds it) is
  solved as M independent graphs in one set of launches: the reference's
  ``vmap``.
- :func:`schur_gn_step` -- one GN step by keyframe-block Schur elimination
  with the loop closures folded in by a Woodbury correction.  The poses
  split into contiguous blocks.  In one process the ``n_blocks`` blocks are
  a leading batch axis (window Hessians [n_blocks, D, D] solved in one
  batched call, each ``psum`` a sum over that axis); on a mesh rank r
  computes block r alone and the boundary system, ``A y0`` and ``A X`` are
  summed over the ranks.  One body (:func:`_schur_blocks`) serves both.
  ``n_blocks = 1`` is the reference on one device (its CLI's
  ``make_mesh(len(jax.devices()))`` on one chip), ``n_blocks = 8`` the
  reference on ``make_mesh(8)``.

The reference accumulates with ``.at[idx].add(..., mode="drop")``, which
drops out-of-range indices (the Schur window sends invalid factors to
local pose B + 1 on purpose), and its gathers clamp.  ``index_add_`` raises
on such an index (on CUDA, a device-side assert), so the CG primitives sum
along an incidence table that leaves dropped endpoints out, the Schur
step's scatters send a dropped entry to index 0 with a zero value, and
every gather clamps: the same sums as dropping.  Products are float32 (TF32 off,
``ops.frontend.use_f32_matmuls``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.core.geometry import wrap_angle
from radar_slam_tpu_torch.ops.frontend import use_f32_matmuls
from radar_slam_tpu_torch.parallel.mesh import Mesh
from radar_slam_tpu_torch.parallel.posegraph import (PoseGraph,
                                                     anchor_residual,
                                                     clamp_index,
                                                     factor_jacobians,
                                                     factor_residuals,
                                                     total_cost)
from radar_slam_tpu_torch.utils.host import device_get


# ---------------------------------------------------------------------------
# Factor-block primitives
# ---------------------------------------------------------------------------

def _incidence(graph: PoseGraph, N: int) -> torch.Tensor:
    """For each pose, the rows of the valid factors' endpoints that land
    on it, as indices into the [2M] endpoint rows (factor m's i-endpoint at
    2m, its j-endpoint at 2m + 1), padded with 2M (a zero row): [N, K].

    Ordered as the reference's scatters add them (every i-endpoint by
    factor, then every j-endpoint), so a sum along K is a fixed-order
    reduction: the same bits on every run, where ``index_add_`` on CUDA
    adds in the order its atomics land.  Endpoints outside [0, N) after
    wrapping negatives are left out, as ``mode="drop"`` drops them.  A
    stacked graph's endpoints [S, M] are read per sequence and its table
    covers the S * N poses of :func:`_flatten`.  One host read of the
    endpoints; the graph's topology is fixed for a solve."""
    fi, fj, valid = (np.atleast_2d(x) for x in device_get(
        (graph.fi, graph.fj, graph.factor_valid)))
    S = fi.shape[0]
    ends = np.stack([fi, fj]).astype(np.int64)                 # [2, S, M]
    ends = np.where(ends < 0, ends + N, ends)
    keep = ((ends >= 0) & (ends < N) & valid[None]).reshape(2, -1)
    ends = (ends + N * np.arange(S)[:, None]).reshape(2, -1)
    M = ends.shape[1]
    k, m = np.nonzero(keep)                                    # (k, m) order
    pose = ends[k, m]
    order = np.argsort(pose, kind="stable")
    pose, slot = pose[order], (2 * m + k)[order]
    counts = np.bincount(pose, minlength=S * N)
    rank = np.arange(len(pose)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    table = np.full((S * N, max(int(counts.max(initial=0)), 1)), 2 * M,
                    np.int64)
    table[pose, rank] = slot
    return torch.as_tensor(table, device=graph.fi.device)


def _flatten(graph: PoseGraph) -> PoseGraph:
    """A stacked graph [S, ...] as one graph over its S * N poses: each
    sequence's endpoints read as JAX reads them (``clamp_index``), then
    offset by s * N.  Its anchor fields are the stacked graph's."""
    S, N, D = graph.poses.shape
    off = N * torch.arange(S, device=graph.poses.device)[:, None]
    return graph._replace(
        poses=graph.poses.reshape(S * N, D),
        fi=(clamp_index(graph.fi, N) + off).reshape(-1),
        fj=(clamp_index(graph.fj, N) + off).reshape(-1),
        delta=graph.delta.reshape(-1, D), info=graph.info.reshape(-1, D),
        factor_valid=graph.factor_valid.reshape(-1))


class _Linear(NamedTuple):
    """One linearization of the factors, endpoints interleaved (i, j)."""
    gather: torch.Tensor   # [2M] int64 endpoint rows read (JAX's clamping)
    table: torch.Tensor    # [N, K] int64 incidence (:func:`_incidence`)
    J: torch.Tensor        # [M, 2, D, D] (Ji, Jj)
    w: torch.Tensor        # [M, D] weights, 0 for invalid factors


def _linearize(poses: torch.Tensor, graph: PoseGraph,
               table: Optional[torch.Tensor] = None) -> _Linear:
    N = poses.shape[0]
    ends = torch.stack([graph.fi, graph.fj], dim=1).reshape(-1).long()
    Ji, Jj = factor_jacobians(poses, graph)
    w = graph.factor_valid[:, None] * graph.info
    gather = clamp_index(ends, N)
    if table is None:
        table = _incidence(graph, N)
    return _Linear(gather, table, torch.stack([Ji, Jj], dim=1), w)


def _scatter(lin: _Linear, rows: torch.Tensor) -> torch.Tensor:
    """Per-endpoint rows [M, 2, D] summed into [N, D] along the incidence
    table (a fixed-order sum)."""
    flat = rows.reshape(-1, rows.shape[-1])
    ext = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    return ext[lin.table].sum(dim=1)


def _block_gradient(poses, graph: PoseGraph, lin: Optional[_Linear] = None):
    """g = J^T W r accumulated into a full-length [N, D] array."""
    lin = lin if lin is not None else _linearize(poses, graph)
    wr = lin.w * factor_residuals(poses, graph)                 # [M, D]
    return _scatter(lin, torch.sum(lin.J * wr[:, None, :, None], dim=2))


def _block_hvp(poses, graph: PoseGraph, v, lin: Optional[_Linear] = None):
    """(J^T W J) v accumulated into a full-length [N, D] array."""
    lin = lin if lin is not None else _linearize(poses, graph)
    M, D = lin.w.shape
    vg = v[lin.gather].view(M, 2, 1, D)
    wJv = lin.w * torch.sum(lin.J * vg, dim=(1, 3))             # [M, D]
    return _scatter(lin, torch.sum(lin.J * wJv[:, None, :, None], dim=2))


def _block_diag(poses, graph: PoseGraph, lin: Optional[_Linear] = None):
    """diag(J^T W J) for the Jacobi preconditioner."""
    lin = lin if lin is not None else _linearize(poses, graph)
    return _scatter(lin, torch.sum(lin.J * lin.w[:, None, :, None] * lin.J,
                                   dim=2))


def _anchor_terms(poses, graph: PoseGraph):
    """The anchor prior's gradient, at pose 0 of each (stacked) graph."""
    ra = poses[..., 0, :] - graph.anchor
    ra = torch.cat([ra[..., :-1], wrap_angle(ra[..., -1:])], dim=-1)
    g = torch.zeros_like(poses)
    g[..., 0, :] = graph.anchor_info * ra
    return g


# ---------------------------------------------------------------------------
# GN + CG
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-graph inner products of [S, N, D] arrays, [S, 1, 1]."""
    return torch.sum(a * b, dim=(1, 2), keepdim=True)


def gauss_newton_cg(graph: PoseGraph, mesh: Optional[Mesh] = None,
                    gn_iters: int = 10, cg_iters: int = 50,
                    damping: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton with preconditioned-CG inner solves.  Returns
    (optimized poses [N, D], cost), or ([S, N, D], [S]) for a stacked
    graph.

    With ``mesh`` each rank sums its block of the factor axis (a multiple
    of the mesh size, as the reference's shard_map requires) and the sums
    are added over the ranks; every rank returns the same poses.  Without
    it, the reference at ``mesh=None``."""
    use_f32_matmuls()
    stacked = graph.poses.dim() == 3
    g = graph if stacked else PoseGraph(*[x[None] for x in graph])
    S, N, D = g.poses.shape
    part = g
    if mesh is not None:
        rows = mesh.block(g.fi.shape[1])
        part = g._replace(fi=g.fi[:, rows], fj=g.fj[:, rows],
                          delta=g.delta[:, rows], info=g.info[:, rows],
                          factor_valid=g.factor_valid[:, rows])
    flat = _flatten(part)
    table = _incidence(part, N)

    def reduce(x):
        x = x if mesh is None else mesh.all_reduce(x)
        return x.view(S, N, D)

    poses = g.poses
    anchor_mask = torch.zeros_like(poses)
    anchor_mask[:, 0] = g.anchor_info
    for _ in range(gn_iters):
        pf = poses.reshape(S * N, D)
        lin = _linearize(pf, flat, table)
        grad = reduce(_block_gradient(pf, flat, lin)) \
            + _anchor_terms(poses, g)
        diag = reduce(_block_diag(pf, flat, lin))
        diag[:, 0] += g.anchor_info
        minv = 1.0 / (diag + damping)

        # Preconditioned CG on H dx = -g, a fixed cg_iters steps.
        x = torch.zeros_like(grad)
        r = -grad
        z = minv * r
        p = r * minv
        rz = _dot(r, z)
        for _ in range(cg_iters):
            hp = reduce(_block_hvp(pf, flat, p.view(S * N, D), lin))
            hp = hp.addcmul_(anchor_mask, p).add_(p, alpha=damping)
            alpha = rz / torch.clamp_min(_dot(p, hp), 1e-30)
            x = x.addcmul(alpha, p)
            r = r.addcmul(alpha, hp, value=-1.0)
            z = minv * r
            rz2 = _dot(r, z)
            beta = rz2 / torch.clamp_min(rz, 1e-30)
            p = z.addcmul(beta, p)
            rz = rz2
        poses = poses + x
        poses = torch.cat([poses[..., :-1], wrap_angle(poses[..., -1:])],
                          dim=-1)
    cost = torch.stack([total_cost(poses[s], PoseGraph(*[x[s] for x in g]))
                        for s in range(S)])
    return (poses, cost) if stacked else (poses[0], cost[0])


# ---------------------------------------------------------------------------
# Schur-complement block elimination (chain + loop closures)
# ---------------------------------------------------------------------------

def _add_at(n: int, idx: torch.Tensor, keep: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """Flat [n] sums of ``vals`` at ``idx`` where ``keep``; dropped entries
    go to index 0 with value 0."""
    return vals.new_zeros(n).index_add_(
        0, torch.where(keep, idx, 0).reshape(-1),
        torch.where(keep, vals, 0.0).reshape(-1))


def schur_gn_step(graph: PoseGraph, n_blocks: int = 1,
                  damping: float = 1e-5, n_chain: Optional[int] = None,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One GN step via keyframe-block Schur elimination, with loop closures
    folded in exactly by a Woodbury low-rank correction.

    Poses are partitioned into ``n_blocks`` contiguous blocks of B.  The
    step solves (Hc + A^T W A) dx = -g, where Hc is the chain Hessian
    (odometry factors + anchor + damping) and A^T W A the loop Hessian of
    the L loop slots.  Each block assembles its dense window Hessian over
    its B poses and the next block's first pose, factors its interior once
    for the 2 Dp + 1 + Dp L right-hand sides [Hbi^T | g | A^T], and
    contributes a 2 Dp x 2 Dp Schur system over the block-boundary poses;
    the summed boundary system is solved once, the interiors
    back-substitute, and the loops enter through

        (Hc + A^T W A)^{-1} g = y0 - X (I + W A X)^{-1} W A y0,
        X = Hc^{-1} A^T,  y0 = Hc^{-1} g.

    Args:
        n_blocks: the block count in one process (the reference's mesh
            size); N must be a multiple of it.
        n_chain: number of leading chain-factor slots in the graph (default
            N - 1, the ``from_velocities`` layout); slots beyond it are loop
            closures (valid or not).
        mesh: one block a rank (the reference's mesh): rank r computes
            block r, the boundary system, ``A y0`` and ``A X`` are summed
            over the ranks, and every rank returns all poses.
    Returns the new poses [N, Dp].
    """
    use_f32_matmuls()
    N = graph.poses.shape[0]
    if mesh is not None and n_blocks not in (1, mesh.size):
        raise ValueError(f"n_blocks={n_blocks} on a mesh of {mesh.size}: "
                         f"the mesh sets the blocks")
    nb = n_blocks if mesh is None else mesh.size
    if N % nb:
        raise ValueError(f"{N} poses: pad keyframes to a multiple of "
                         f"n_blocks={nb}")
    if mesh is None:
        bodies = [_schur_block(graph, nb, b, damping, n_chain)
                  for b in range(nb)]
        new_poses = _run_blocks(bodies, lambda parts: tuple(
            functools.reduce(torch.add, xs) for xs in zip(*parts)))
    else:
        body = _schur_block(graph, nb, mesh.rank, damping, n_chain)
        new_poses = mesh.gather(_run_blocks([body], lambda parts: tuple(
            mesh.all_reduce(x) for x in parts[0])))
    return torch.cat([new_poses[:, :-1], wrap_angle(new_poses[:, -1:])],
                     dim=1)


def _run_blocks(bodies, reduce) -> torch.Tensor:
    """Drive the block bodies of :func:`_schur_block` in step: at each of
    their sums over blocks, ``reduce`` the partials they yield (a sum in
    block order in one process, an all-reduce over the ranks on a mesh)
    and send the sum back.  Returns their poses, concatenated."""
    parts = [next(body) for body in bodies]
    while True:
        total = reduce(parts)
        parts, done = [], []
        for body in bodies:
            try:
                parts.append(body.send(total))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            return torch.cat(done)


def _schur_block(graph: PoseGraph, nb: int, b: int, damping: float,
                 n_chain: Optional[int]):
    """The Schur step's body for block ``b`` of ``nb`` (a generator): its
    window, its share of the boundary system and of ``A y0`` and ``A X``,
    each yielded to be summed over the blocks and received back, then its
    poses after the step, [B, Dp], yaw unwrapped, as its return value.
    Every block runs the same arithmetic in either route: at two blocks
    the routes agree bit for bit (a sum of two partials is exact).  The
    window keeps a leading axis of 1, the shape of the one-block step's
    batched solves."""
    poses = graph.poses
    N, Dp = poses.shape
    dev = poses.device
    B = N // nb
    s0, s1 = b * B, (b + 1) * B             # the block's poses and slots
    if n_chain is None:
        n_chain = N - 1
    L = graph.fi.shape[0] - n_chain     # loop slots (static)
    ar = torch.arange(Dp, device=dev)

    # Chain factors re-laid-out to N slots (slot k <-> factor (k, k+1)), so
    # block b's rows of the slot axis are exactly its window's factors.
    def chain_pad(x):
        return torch.cat([x[:n_chain],
                          x.new_zeros((N - n_chain,) + x.shape[1:])])[s0:s1]

    chain = graph._replace(fi=chain_pad(graph.fi), fj=chain_pad(graph.fj),
                           delta=chain_pad(graph.delta),
                           info=chain_pad(graph.info),
                           factor_valid=chain_pad(graph.factor_valid))
    if L == 0:
        # One dummy invalid slot keeps every shape nonzero; its zero weight
        # makes the Woodbury correction exactly zero.
        loop = graph._replace(
            fi=torch.zeros(1, dtype=graph.fi.dtype, device=dev),
            fj=torch.ones(1, dtype=graph.fj.dtype, device=dev),
            delta=graph.delta.new_zeros((1, Dp)),
            info=graph.info.new_zeros((1, Dp)),
            factor_valid=torch.zeros(1, dtype=torch.bool, device=dev))
    else:
        loop = graph._replace(fi=graph.fi[n_chain:], fj=graph.fj[n_chain:],
                              delta=graph.delta[n_chain:],
                              info=graph.info[n_chain:],
                              factor_valid=graph.factor_valid[n_chain:])

    # ---- per-block dense chain Hessian over the (B+1)-pose window --------
    r = factor_residuals(poses, chain)                          # [B, Dp]
    Ji, Jj = factor_jacobians(poses, chain)
    w = chain.factor_valid[:, None] * chain.info
    J = torch.stack([Ji, Jj], dim=1)                            # [B,2,Dp,Dp]

    # Local endpoint indices within the window; invalid factors sit at
    # B + 1, outside it, so their entries are dropped.
    slots = torch.arange(s0, s1, device=dev)
    base = (slots // B) * B
    valid = chain.factor_valid
    loc = torch.stack([torch.where(valid, chain.fi.long() - base, B + 1),
                       torch.where(valid, chain.fj.long() - base, B + 1)],
                      dim=1)                                    # [B, 2]
    inside = loc <= B

    D = Dp * (B + 1)
    # blocks[m, k, l] = J_k^T W J_l of factor m (k, l: endpoint i or j).
    blocks = torch.sum(w[:, None, None, :, None, None]
                       * J[:, :, None, :, :, None]
                       * J[:, None, :, :, None, :], dim=3)      # [B,2,2,Dp,Dp]
    rows = Dp * loc[:, :, None] + ar                            # [B, 2, Dp]
    flat = rows[:, :, None, :, None] * D + rows[:, None, :, None, :]
    keep = (inside[:, :, None] & inside[:, None, :])[..., None, None]
    H = _add_at(D * D, flat, keep.expand_as(flat), blocks).view(1, D, D)

    # Chain gradient into the window.
    gc = torch.sum(J * (w * r)[:, None, :, None], dim=2)        # [B, 2, Dp]
    g = _add_at(D, rows, inside[:, :, None].expand_as(rows),
                gc).view(1, D)

    # Anchor on global pose 0 (block 0, local pose 0).
    if b == 0:
        ra = anchor_residual(poses, graph)
        H.diagonal(dim1=-2, dim2=-1)[0, :Dp] += graph.anchor_info
        g[0, :Dp] += graph.anchor_info * ra
    H.diagonal(dim1=-2, dim2=-1).add_(damping)

    # ---- loop factor linearization (every block holds it; tiny) ----------
    rl = factor_residuals(poses, loop)                          # [L, Dp]
    Jl = torch.stack(factor_jacobians(poses, loop), dim=1)      # [L, 2, Dp, Dp]
    wl = (loop.factor_valid[:, None] * loop.info).reshape(-1)   # [Dp L]
    Lr = rl.shape[0]
    # A [Dp L, Dp N]: rows of loop-residual Jacobians.
    lends = torch.stack([loop.fi, loop.fj], dim=1).long()       # [L, 2]
    lrow = Dp * torch.arange(Lr, device=dev)[:, None] + ar      # [L, Dp]
    lcol = Dp * lends[:, :, None] + ar                          # [L, 2, Dp]
    aflat = lrow[:, None, :, None] * (Dp * N) + lcol[:, :, None, :]
    lkeep = ((lends >= 0) & (lends < N))[:, :, None, None]
    A = _add_at(Dp * Lr * Dp * N, aflat, lkeep.expand_as(aflat),
                Jl).view(Dp * Lr, Dp * N)
    A_own = A[:, Dp * s0:Dp * s1]                               # [Dp L, Dp B]

    # The loop gradient A^T W r_l; each pose's share goes to the block
    # that owns it (local rows 0..B-1), so the boundary sum counts it once.
    g_loop = A_own.T @ (wl * rl.reshape(-1))                    # [Dp B]
    g[:, :Dp * B] += g_loop.view(1, Dp * B)

    # ---- right-hand sides: [g | A^T rows owned by the block] -------------
    C = 1 + Dp * Lr
    rhs = H.new_zeros((1, D, C))
    rhs[:, :, 0] = g
    rhs[:, :Dp * B, 1:] = A_own.T.reshape(1, Dp * B, Dp * Lr)

    # ---- interior elimination (factor once, solve all RHS) ---------------
    # Boundary: local poses 0 and B; interior: local poses 1..B-1.
    bsel = torch.cat([ar, Dp * B + ar])
    Hbb = H[:, bsel[:, None], bsel[None, :]]                    # [1, 2Dp, 2Dp]
    Hbi = H[:, bsel, Dp:Dp * B]                                 # [1, 2Dp, I]
    Hii = H[:, Dp:Dp * B, Dp:Dp * B]
    rb = rhs[:, bsel]                                           # [1, 2Dp, C]
    ri = rhs[:, Dp:Dp * B]                                      # [1, I, C]
    del H
    # solve_ex: no host read of the factorization's status, as the
    # reference's solve returns whatever LU gives.
    Hii_inv = torch.linalg.solve_ex(
        Hii, torch.cat([Hbi.transpose(1, 2), ri], dim=2))[0]
    Hii_inv_Hib = Hii_inv[:, :, :2 * Dp]
    Hii_inv_ri = Hii_inv[:, :, 2 * Dp:]
    S_local = Hbb - Hbi @ Hii_inv_Hib                           # [1, 2Dp, 2Dp]
    y_local = rb - Hbi @ Hii_inv_ri                             # [1, 2Dp, C]

    # ---- global boundary system: sum over blocks, one solve --------------
    W = Dp * (nb + 1)
    brow = (Dp * b + torch.arange(2 * Dp, device=dev))[None]    # [1, 2Dp]
    ones = torch.ones((), dtype=torch.bool, device=dev)
    Sg, yg = yield (
        _add_at(W * W, brow[:, :, None] * W + brow[:, None, :],
                ones.expand(1, 2 * Dp, 2 * Dp), S_local),
        S_local.new_zeros((W, C)).index_add_(
            0, brow.reshape(-1), y_local.reshape(2 * Dp, C)))
    # The last boundary id (pose N, nonexistent) has empty rows.
    Sg = Sg.view(W, W).clone()
    Sg.diagonal().add_(1e-12)
    db = torch.linalg.solve_ex(Sg, yg)[0]                       # [W, C]

    db_local = db[brow]                                         # [1, 2Dp, C]
    di = Hii_inv_ri - Hii_inv_Hib @ db_local                    # [1, I, C]
    # Owned rows (local poses 0..B-1) of the solutions Hc^{-1} [g | A^T].
    sol_own = torch.cat([db_local[:, :Dp], di], dim=1)          # [1, Dp B, C]
    y0_own = sol_own[:, :, 0]
    X_own = sol_own[:, :, 1:]

    # ---- Woodbury loop correction ----------------------------------------
    Ay0, AX = yield (A_own @ y0_own.reshape(-1),               # [Dp L]
                     A_own @ X_own.reshape(Dp * B, Dp * Lr))
    K = torch.eye(Dp * Lr, device=dev) + wl[:, None] * AX
    corr = torch.linalg.solve_ex(K, (wl * Ay0)[:, None])[0][:, 0]
    dxb = -(y0_own - X_own @ corr)                              # [1, Dp B]
    return poses[s0:s1] + dxb.reshape(B, Dp)
