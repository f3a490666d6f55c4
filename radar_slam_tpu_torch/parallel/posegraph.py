"""Pose-graph construction (keyframes + odometry + loop factors).

Counterpart of ``radar_slam_tpu/parallel/posegraph.py``.  A trajectory is a
factor graph over keyframe poses, planar SE(2) p_i = (x, y, yaw) or z-aware
p_i = (x, y, z, yaw) (selected by the trailing dimension of ``poses``; yaw
is always LAST and rotates the xy plane only):

- odometry factors from the per-frame velocity solves:
  r_i = [R(yaw_i)^T (t_{i+1} - t_i) - dt_i ; (dz_i - dz_meas) ;
         wrap(yaw_{i+1} - yaw_i - dyaw_i)]
- an anchor prior on p_0;
- optional loop-closure factors of the same form between arbitrary (i, j),
  in slots pre-allocated after the chain factors.

Every factor array has a static shape with a validity mask.  Graphs and
their tensors are data: the device comes from the inputs.
:func:`posegraph_from_numpy` builds a graph from a dict of arrays (the
reference's graph fetched to numpy, for example).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.core.geometry import wrap_angle


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # [N, D] estimates; D=3 (x,y,yaw) or 4 (x,y,z,yaw)
    fi: torch.Tensor           # [M] int32 factor endpoint i
    fj: torch.Tensor           # [M] int32 factor endpoint j
    delta: torch.Tensor        # [M, D] measured body-frame motion i -> j
    info: torch.Tensor         # [M, D] diagonal information (weights)
    factor_valid: torch.Tensor  # [M] bool
    anchor: torch.Tensor       # [D] prior pose for p_0
    anchor_info: torch.Tensor  # [D] prior information


def posegraph_from_numpy(arrays: Dict[str, np.ndarray],
                         device="cpu") -> PoseGraph:
    """A :class:`PoseGraph` from a dict of arrays keyed by field name
    (int32 endpoints, bool validity, float32 otherwise), on ``device``."""
    dtypes = {"fi": torch.int32, "fj": torch.int32,
              "factor_valid": torch.bool}
    return PoseGraph(**{
        k: torch.as_tensor(np.array(arrays[k]),
                           dtype=dtypes.get(k, torch.float32), device=device)
        for k in PoseGraph._fields})


def from_velocities(velocities: torch.Tensor, yaw_rates: torch.Tensor,
                    success: torch.Tensor, dt: float,
                    odo_info: Tuple[float, ...] = (100.0, 100.0, 400.0),
                    loop_capacity: int = 0,
                    initial_poses: Optional[torch.Tensor] = None,
                    use_z: bool = False) -> PoseGraph:
    """Build a chain graph from per-frame velocity estimates.

    Args:
        velocities: [F, 3] body velocities (frame f covers [t_f, t_{f+1})).
        yaw_rates: [F].
        success: [F] bool; failed frames get zero-motion factors with weak
            information.
        use_z: build the z-aware (x, y, z, yaw) graph, consuming
            ``velocities[:, 2]`` as the vertical rate.  ``odo_info`` may
            then have 4 entries (x, y, z, yaw); a 3-entry tuple reuses the x
            weight for z.
    Returns a graph with N = F + 1 poses on the device of ``velocities``.
    """
    dev = velocities.device
    F = velocities.shape[0]
    n_t = 3 if use_z else 2
    d_t = torch.where(success[:, None], velocities[:, :n_t], 0.0) * dt
    d_yaw = torch.where(success, yaw_rates, 0.0) * dt
    delta = torch.cat([d_t, d_yaw[:, None]], dim=-1)           # [F, D]

    oi = tuple(odo_info)
    if use_z and len(oi) == 3:
        oi = (oi[0], oi[1], oi[0], oi[2])
    oi_t = torch.tensor(oi, dtype=torch.float32, device=dev)[None, :]
    info = torch.where(success[:, None], oi_t, oi_t * 1e-2)

    # Initial poses: open-loop integration of the deltas (yaw rotates the
    # xy plane only; z accumulates directly).
    if initial_poses is None:
        yaw = torch.cat([torch.zeros(1, device=dev),
                         torch.cumsum(d_yaw, 0)])
        c, s = torch.cos(yaw[:-1]), torch.sin(yaw[:-1])
        step = torch.stack([c * delta[:, 0] - s * delta[:, 1],
                            s * delta[:, 0] + c * delta[:, 1]], dim=-1)
        if use_z:
            step = torch.cat([step, delta[:, 2:3]], dim=-1)
        t = torch.cat([torch.zeros((1, n_t), device=dev),
                       torch.cumsum(step, 0)])
        initial_poses = torch.cat([t, yaw[:, None]], dim=-1)

    fi = torch.arange(F, dtype=torch.int32, device=dev)
    fj = fi + 1
    valid = torch.ones(F, dtype=torch.bool, device=dev)
    if loop_capacity:
        def pad(x):
            return torch.cat([x, x.new_zeros((loop_capacity,) + x.shape[1:])])
        fi, fj, delta, info, valid = (pad(x) for x in
                                      (fi, fj, delta, info, valid))

    return PoseGraph(
        poses=initial_poses, fi=fi, fj=fj, delta=delta, info=info,
        factor_valid=valid, anchor=initial_poses[0],
        anchor_info=torch.full((n_t + 1,), 1e6, device=dev))


def add_loop_closure(graph: PoseGraph, slot: int, i: int, j: int,
                     delta, info) -> PoseGraph:
    """Fill one pre-allocated loop-closure slot (after the chain factors);
    returns a new graph and leaves ``graph`` as it was."""
    k = graph.poses.shape[0] - 1 + slot

    def put(x, value):
        x = x.clone()
        x[k] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
        return x

    return graph._replace(
        fi=put(graph.fi, i), fj=put(graph.fj, j),
        delta=put(graph.delta, delta), info=put(graph.info, info),
        factor_valid=put(graph.factor_valid, True))


def clamp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as JAX reads an axis of length n with it: negative indices
    count from the end, and out-of-range ones clamp (torch raises)."""
    idx = idx.long()
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _endpoints(poses: torch.Tensor, graph: PoseGraph):
    N = poses.shape[0]
    pi = poses[clamp_index(graph.fi, N)]
    pj = poses[clamp_index(graph.fj, N)]
    c, s = torch.cos(pi[:, -1]), torch.sin(pi[:, -1])
    return pi, pj, c, s, pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]


def factor_residuals(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Residuals [M, D] of all factors at the given pose estimates.

    Yaw (last component) rotates the xy plane; with D=4 the z component is
    a pure translation residual."""
    pi, pj, c, s, dx, dy = _endpoints(poses, graph)
    r_x = c * dx + s * dy - graph.delta[:, 0]
    r_y = -s * dx + c * dy - graph.delta[:, 1]
    r_t = wrap_angle(pj[:, -1] - pi[:, -1] - graph.delta[:, -1])
    if poses.shape[-1] == 4:
        r_z = pj[:, 2] - pi[:, 2] - graph.delta[:, 2]
        return torch.stack([r_x, r_y, r_z, r_t], dim=-1)
    return torch.stack([r_x, r_y, r_t], dim=-1)


def factor_jacobians(poses: torch.Tensor, graph: PoseGraph):
    """Jacobian blocks (Ji [M, D, D], Jj [M, D, D]) of the residuals."""
    _, _, c, s, dx, dy = _endpoints(poses, graph)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    # d r_xy / d theta_i = d(R^T)/dtheta @ (tj - ti)
    drx_dth = -s * dx + c * dy
    dry_dth = -c * dx - s * dy

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    if poses.shape[-1] == 4:
        Ji = mat([[-c, -s, zeros, drx_dth], [s, -c, zeros, dry_dth],
                  [zeros, zeros, -ones, zeros],
                  [zeros, zeros, zeros, -ones]])
        Jj = mat([[c, s, zeros, zeros], [-s, c, zeros, zeros],
                  [zeros, zeros, ones, zeros], [zeros, zeros, zeros, ones]])
        return Ji, Jj
    Ji = mat([[-c, -s, drx_dth], [s, -c, dry_dth], [zeros, zeros, -ones]])
    Jj = mat([[c, s, zeros], [-s, c, zeros], [zeros, zeros, ones]])
    return Ji, Jj


def anchor_residual(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """p_0 - anchor with its yaw wrapped, [D]."""
    ra = poses[0] - graph.anchor
    return torch.cat([ra[:-1], wrap_angle(ra[-1:])])


def total_cost(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    r = factor_residuals(poses, graph)
    w = graph.factor_valid[:, None] * graph.info
    cost = torch.sum(w * r * r)
    ra = anchor_residual(poses, graph)
    return cost + torch.sum(graph.anchor_info * ra * ra)
