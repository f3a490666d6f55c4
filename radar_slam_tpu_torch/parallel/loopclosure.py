"""Radar loop-closure detection + SE(2) scan matching.

Counterpart of ``radar_slam_tpu/parallel/loopclosure.py``:

- per-frame radar detection sets double as sparse 2-D scan point clouds;
- revisit candidates are keyframe pairs whose *estimated* poses are close
  but temporally distant (host numpy over the [F, F] distance matrix, by
  design: ``scancontext.py`` is the scalable proposer);
- each candidate is verified and measured by a masked SE(2) ICP between the
  two detection sets, batched over candidates on the device (a leading
  candidate axis where the reference vmaps, and a Python loop of
  ``icp_iters`` steps where it runs ``fori_loop``; nothing in the loop
  reads the device);
- accepted matches become loop-closure factors for the pose-graph solvers
  (``parallel/ba.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.utils.host import device_get


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    revisit_radius: float = 5.0       # candidate gate on estimated poses [m]
    min_separation: int = 20          # frames between keyframes
    icp_iters: int = 8
    match_gate: float = 2.0           # NN correspondence gate [m]
    min_inliers: int = 8
    max_rmse: float = 0.7             # accept threshold on matched RMSE [m]
    max_candidates: int = 16          # static candidate budget
    info_scale: float = 200.0         # factor information per accepted loop
    # Odometry-consistency gate for descriptor-retrieved loops: a loop is
    # rejected when its ICP delta disagrees with the odometry-integrated
    # relative pose by more than ``odo_gate_abs + odo_gate_frac *
    # path_length(i..j)`` (an aliased match claims a revisit across a full
    # pattern period, genuine drift only the accumulated error).
    odo_gate_frac: float = 0.35
    odo_gate_abs: float = 2.0


def _se2_apply(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply poses (x, y, yaw) [..., 3] to points [..., K, 2]."""
    c = torch.cos(pose[..., 2:3])
    s = torch.sin(pose[..., 2:3])
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + pose[..., 0:1],
                        s * x + c * y + pose[..., 1:2]], dim=-1)


def _se2_fit(src: torch.Tensor, dst: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid SE(2) fits dst ~= R src + t (2-D Umeyama, no scale)
    over the last point axis: src, dst [..., K, 2], w [..., K] ->
    [..., 3]."""
    wsum = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-6)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum          # [..., 2]
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    sc = (src - mu_s[..., None, :]) * w[..., None]
    dc = dst - mu_d[..., None, :]
    # H = sc^T dc ; SE(2) rotation angle from the 2x2 cross-covariance.
    h00 = torch.sum(sc[..., 0] * dc[..., 0], dim=-1)
    h01 = torch.sum(sc[..., 0] * dc[..., 1], dim=-1)
    h10 = torch.sum(sc[..., 1] * dc[..., 0], dim=-1)
    h11 = torch.sum(sc[..., 1] * dc[..., 1], dim=-1)
    yaw = torch.atan2(h01 - h10, h00 + h11)
    c, s = torch.cos(yaw), torch.sin(yaw)
    tx = mu_d[..., 0] - (c * mu_s[..., 0] - s * mu_s[..., 1])
    ty = mu_d[..., 1] - (s * mu_s[..., 0] + c * mu_s[..., 1])
    return torch.stack([tx, ty, yaw], dim=-1)


def _masked_d2(pose, src_pts, src_valid, dst_pts, dst_valid):
    """Squared distances [..., K, K'] of the moved source points to the
    destination points, 1e9 where either point is invalid."""
    moved = _se2_apply(pose, src_pts)
    d2 = torch.sum((moved[..., :, None, :] - dst_pts[..., None, :, :]) ** 2,
                   dim=-1)
    ok = src_valid[..., :, None] & dst_valid[..., None, :]
    return torch.where(ok, d2, 1e9)


def icp_se2(src_pts: torch.Tensor, src_valid: torch.Tensor,
            dst_pts: torch.Tensor, dst_valid: torch.Tensor,
            init: torch.Tensor, iters: int = 8,
            gate: float = 2.0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked point-to-point SE(2) ICP, batched over leading axes.

    Args:
        src_pts / dst_pts: [..., K, 2] body-frame detection positions.
        init: [..., 3] initial relative pose (x, y, yaw) mapping src into
            dst frame.

    Returns:
        (pose [..., 3], rmse [...], n_inliers [...] int32).
    """
    pose = init.to(src_pts.dtype)
    batch = torch.broadcast_shapes(pose.shape[:-1], src_pts.shape[:-2],
                                   dst_pts.shape[:-2])
    dst_b = dst_pts.expand(*batch, *dst_pts.shape[-2:])
    for _ in range(iters):
        d2 = _masked_d2(pose, src_pts, src_valid, dst_pts, dst_valid)
        # argmin takes the first minimum, as jnp.argmin does.
        dmin2, j = torch.min(d2, dim=-1)
        w = (src_valid & (torch.sqrt(dmin2) < gate)).to(src_pts.dtype)
        matched = torch.gather(dst_b, -2, j[..., None].expand(*j.shape, 2))
        pose = _se2_fit(src_pts, matched, w)

    d2 = _masked_d2(pose, src_pts, src_valid, dst_pts, dst_valid)
    dmin = torch.sqrt(torch.amin(d2, dim=-1))
    inlier = src_valid & (dmin < gate)
    n = torch.sum(inlier, dim=-1, dtype=torch.int32)
    rmse = torch.sqrt(torch.sum(torch.where(inlier, dmin ** 2, 0.0), dim=-1)
                      / torch.clamp_min(n, 1))
    return pose, rmse, n


def _relative_pose(pi: np.ndarray, pj: np.ndarray) -> np.ndarray:
    """Pose of frame j expressed in frame i (host helper)."""
    c, s = np.cos(pi[2]), np.sin(pi[2])
    dx, dy = pj[0] - pi[0], pj[1] - pi[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, pj[2] - pi[2]])


def _icp_pairs(points, valid, ii, jj, init, cfg: LoopClosureConfig):
    """ICP of frame j's points into frame i's for each pair, from
    ``init`` [P, 3] or [P, I, 3] (I inits per pair); one host read of the
    results (delta = T_i^-1 T_j, rmse, inliers)."""
    dev = points.device
    ii_t = torch.as_tensor(ii, dtype=torch.long, device=dev)
    jj_t = torch.as_tensor(jj, dtype=torch.long, device=dev)
    x0 = torch.as_tensor(init, dtype=torch.float32, device=dev)
    src, sv = points[jj_t], valid[jj_t]
    dst, dv = points[ii_t], valid[ii_t]
    if x0.dim() == 3:
        src, sv, dst, dv = (t[:, None] for t in (src, sv, dst, dv))
    return device_get(icp_se2(src, sv, dst, dv, x0, iters=cfg.icp_iters,
                              gate=cfg.match_gate))


def find_loop_closures(points: torch.Tensor, valid: torch.Tensor,
                       poses: np.ndarray,
                       cfg: LoopClosureConfig = LoopClosureConfig()
                       ) -> List[dict]:
    """Detect and verify loop closures over a sequence.

    Args:
        points: [F, K, 2] per-frame detection positions (body frame).
        valid: [F, K] masks.
        poses: [F, 3] current (drifty) pose estimates, host numpy.

    Returns:
        list of dicts {i, j, delta, rmse, inliers} with delta = pose of
        frame j in frame i, ready for
        ``posegraph.add_loop_closure(graph, slot, i, j, delta, info)``.
    """
    poses = np.asarray(poses)
    F = len(poses)
    # Candidate pairs: close in space, far in time; keep the closest i per
    # query j, budgeted.  One [F, F] distance matrix, host numpy.
    d = np.linalg.norm(poses[None, :, :2] - poses[:, None, :2], axis=-1)
    i_idx = np.arange(F)[None, :]
    j_idx = np.arange(F)[:, None]
    # Temporal gate convention: pairs with j - i >= min_separation.
    d = np.where(i_idx <= j_idx - cfg.min_separation, d, np.inf)
    best_i = np.argmin(d, axis=1)
    best_d = d[np.arange(F), best_i]
    js = np.nonzero(best_d < cfg.revisit_radius)[0]
    cands = [(int(best_i[j]), int(j)) for j in js[:cfg.max_candidates]]
    if not cands:
        return []

    ii = np.array([c[0] for c in cands])
    jj = np.array([c[1] for c in cands])
    init = np.stack([_relative_pose(poses[a], poses[b])
                     for a, b in cands]).astype(np.float32)
    deltas, rmses, inliers = _icp_pairs(points, valid, ii, jj, init, cfg)

    out = []
    for k in range(len(cands)):
        if inliers[k] >= cfg.min_inliers and rmses[k] <= cfg.max_rmse:
            out.append({"i": int(ii[k]), "j": int(jj[k]),
                        "delta": deltas[k], "rmse": float(rmses[k]),
                        "inliers": int(inliers[k])})
    return out
