"""Scan-context loop-closure retrieval: descriptor-based revisit proposal.

Counterpart of ``radar_slam_tpu/parallel/scancontext.py``.  Candidates come
from the radar detections themselves (Scan Context, Kim & Kim IROS 2018,
adapted to sparse 2-D radar point sets), so retrieval does not depend on
odometric drift.  Every stage but the final ranking runs on the device of
the point clouds:

- **Descriptor** ``[R, S]`` (rings x sectors): log-occupancy of detections
  on a polar grid, one ``scatter_add_`` over all frames (with a spill bin
  for dropped points).
- **Ring key** ``[R]``: sector-marginalised occupancy, rotation invariant.
  Stage 1 is one ``[F, R] @ [R, F]`` product and a top-M per query
  (:func:`_stage1_candidates`), or above ``stage1_dense_limit`` keyframes
  a running top-M merge over candidate tiles
  (:func:`_stage1_candidates_tiled`, O(F * tile) memory).  Both take the
  reference's tie order (``lax.top_k``: the smaller index first) from a
  stable descending sort (``ops.frontend.topk_exact``).
- **Stage 2**: the best circular sector shift (= relative yaw) of every
  candidate pair from one FFT cross-correlation along the sector axis.
- **Ranking** is the reference's host numpy (``np.argsort(-sim)`` on the
  fetched scores), and verification the batched ICP of
  ``loopclosure.py`` from two inits per candidate, with the
  odometry-consistency gate on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.ops.frontend import topk_exact, use_f32_matmuls
from radar_slam_tpu_torch.parallel.loopclosure import (LoopClosureConfig,
                                                       _icp_pairs,
                                                       _relative_pose)
from radar_slam_tpu_torch.utils.host import device_get


@dataclasses.dataclass(frozen=True)
class ScanContextConfig:
    n_rings: int = 16
    n_sectors: int = 48
    max_range: float = 45.0      # points beyond are dropped [m]
    min_range: float = 0.5       # points inside are dropped (self-returns)
    top_m: int = 4               # stage-1 candidates kept per query frame
    # Stage-2 floor on the mean occupied-column cosine similarity: a
    # candidate-budget floor at the true-revisit p5 of the reference's
    # characterization (scripts/characterize_scancontext.py);
    # discrimination belongs to the verification tier (ICP + the
    # odometry-consistency gate).
    sim_threshold: float = 0.28
    min_overlap: int = 6         # min mutually occupied sectors per shift
    min_separation: int = 20     # temporal gate [frames]
    max_candidates: int = 16     # static verification budget
    # Above this keyframe count, stage 1 streams candidate tiles through a
    # running top-M merge instead of materializing the [F, F] similarity.
    stage1_dense_limit: int = 4096
    stage1_tile: int = 1024


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula, hi * sqrt(1 + (lo / hi)^2) (torch.hypot
    rounds otherwise, which moves points on a ring edge)."""
    x, y = torch.abs(x), torch.abs(y)
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    h = torch.where(zero, hi, hi * torch.sqrt(
        1 + torch.square(lo / torch.where(zero, 1.0, hi))))
    return torch.where(inf, math.inf, h)


def _bin_scale(n: int, span: float) -> float:
    """n / span as the reference's compiled program has it: XLA folds
    ``x / span * n`` into ``x * c`` with c = f32(f32(1 / f32(span)) * n)."""
    one, f32 = np.float32(1.0), np.float32
    return float((one / f32(span)) * f32(n))


def build_descriptors(points: torch.Tensor, valid: torch.Tensor,
                      cfg: ScanContextConfig) -> torch.Tensor:
    """Scan-context descriptors: [F, K, 2], [F, K] -> [F, R, S], the
    polar log-occupancy of each frame's detections.

    Bins are ``floor(hypot / max_range * R)`` and ``floor((atan2 + pi) /
    2pi * S)`` in float32, computed as the reference's compiled program
    computes them: its hypot formula (:func:`_hypot`) and one product by a
    folded constant (:func:`_bin_scale`), so a point on a bin edge lands
    where the reference puts it."""
    R, S = cfg.n_rings, cfg.n_sectors
    F = points.shape[0]
    rng = _hypot(points[..., 0], points[..., 1])
    az = torch.atan2(points[..., 1], points[..., 0])           # [-pi, pi)
    ring = torch.floor(rng * _bin_scale(R, cfg.max_range)).to(torch.int64)
    sector = torch.floor((az + math.pi)
                         * _bin_scale(S, 2 * math.pi)).to(torch.int64)
    sector = torch.clamp(sector, 0, S - 1)
    ok = valid & (rng >= cfg.min_range) & (rng < cfg.max_range)
    flat = torch.where(ok, ring * S + sector, R * S)           # spill bin
    counts = torch.zeros((F, R * S + 1), dtype=torch.float32,
                         device=points.device)
    counts.scatter_add_(1, flat, torch.ones_like(rng))
    return torch.log1p(counts[:, :-1]).reshape(F, R, S)


def ring_keys(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant ring keys [..., R]: sector-mean, unit-normalised."""
    key = torch.mean(desc, dim=-1)
    return key / torch.clamp_min(
        torch.linalg.vector_norm(key, dim=-1, keepdim=True), 1e-9)


def _unit_columns(desc: torch.Tensor) -> torch.Tensor:
    """Normalise each sector column (over rings) to unit norm."""
    return desc / torch.clamp_min(
        torch.linalg.vector_norm(desc, dim=-2, keepdim=True), 1e-9)


def sc_correlate(desc_a: torch.Tensor, desc_b: torch.Tensor,
                 min_overlap: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan-context similarity maximised over circular sector shifts.

    Args:
        desc_a / desc_b: [..., R, S] descriptors (batch dims broadcast).
        min_overlap: shifts with fewer mutually occupied sectors are
            rejected.

    Returns:
        (sim, shift): sim [...] = max_n mean over mutually occupied sectors
        of cos(a_hat[:, s], b_hat[:, s+n]), and the argmax shift [...]
        (int64; the first maximum, as ``jnp.argmax`` takes) with b's
        sectors advanced by ``shift``.  All S shifts come from one FFT
        cross-correlation along sectors, and so does the occupancy overlap
        count.
    """
    S = desc_a.shape[-1]
    a = _unit_columns(desc_a)
    b = _unit_columns(desc_b)
    occ_a = torch.any(desc_a > 0, dim=-2).to(torch.float32)
    occ_b = torch.any(desc_b > 0, dim=-2).to(torch.float32)
    fa = torch.fft.rfft(a, dim=-1)
    fb = torch.fft.rfft(b, dim=-1)
    # c[n] = sum_r sum_s a[r, s] * b[r, (s + n) mod S]
    corr = torch.fft.irfft(torch.sum(torch.conj(fa) * fb, dim=-2), n=S,
                           dim=-1)
    overlap = torch.fft.irfft(torch.conj(torch.fft.rfft(occ_a, dim=-1))
                              * torch.fft.rfft(occ_b, dim=-1), n=S, dim=-1)
    overlap = torch.round(overlap)
    sim = torch.where(overlap >= min_overlap,
                      corr / torch.clamp_min(overlap, 1.0), -1.0)
    return torch.amax(sim, dim=-1), torch.argmax(sim, dim=-1)


def shift_to_yaw(shift: torch.Tensor, n_sectors: int) -> torch.Tensor:
    """Relative yaw implied by a sector shift.

    For ``sc_correlate(desc_i, desc_j) -> shift``, the yaw of frame j's
    pose expressed in frame i is ``-shift * 2pi / S``, wrapped to
    [-pi, pi)."""
    ang = -shift.to(torch.float32) * (2 * math.pi / n_sectors)
    return torch.atan2(torch.sin(ang), torch.cos(ang))


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------

def _stage1_candidates(keys: torch.Tensor, top_m: int, min_separation: int):
    """Ring-key retrieval: for each query j, the top-M earlier frames i.

    One [F, F] product + top-M; pairs with i > j - min_separation are
    masked out (queries only look backwards in time).  Returns (values
    [F, M], int64 indices [F, M])."""
    use_f32_matmuls()
    F = keys.shape[0]
    sim = keys @ keys.T                                        # [F, F]
    i_idx = torch.arange(F, device=keys.device)[None, :]
    j_idx = torch.arange(F, device=keys.device)[:, None]
    sim = torch.where(i_idx <= j_idx - min_separation, sim, -math.inf)
    return topk_exact(sim, top_m)


def _stage1_candidates_tiled(keys: torch.Tensor, top_m: int,
                             min_separation: int, tile: int = 1024):
    """Stage 1 in O(F * tile) memory: EXACT top-M retrieval streaming
    candidate tiles through a running top-M merge.

    Selects the same candidates as :func:`_stage1_candidates` (values
    within 1 ulp: a tile's product may round otherwise than the whole
    one's); the merge concatenates the running best before the tile, so
    ties keep the smaller index first, as in the dense route."""
    use_f32_matmuls()
    F = keys.shape[0]
    dev = keys.device
    j_idx = torch.arange(F, device=dev)[:, None]
    vals = torch.full((F, top_m), -math.inf, dtype=keys.dtype, device=dev)
    idx = torch.zeros((F, top_m), dtype=torch.int64, device=dev)
    for off in range(0, F, tile):
        ct = keys[off:off + tile]
        if ct.shape[0] < tile:
            ct = torch.cat([ct, ct.new_zeros((tile - ct.shape[0],
                                              ct.shape[1]))])
        sim = keys @ ct.T                                      # [F, tile]
        i_idx = off + torch.arange(tile, device=dev)[None, :]
        admit = (i_idx <= j_idx - min_separation) & (i_idx < F)
        sim = torch.where(admit, sim, -math.inf)
        allv = torch.cat([vals, sim], dim=1)
        alli = torch.cat([idx, i_idx.expand(F, tile)], dim=1)
        vals, sel = topk_exact(allv, top_m)
        idx = torch.gather(alli, 1, sel)
    return vals, idx


def _stage2_scores(desc: torch.Tensor, top_m: int, min_separation: int,
                   min_overlap: int, dense_limit: int = 4096,
                   tile: int = 1024):
    """Full retrieval program: ring-key top-M then FFT-shift similarity.

    Returns per (query j, rank m): stage-1 validity, candidate index i,
    SC similarity, best sector shift (flat [F * M] each)."""
    keys = ring_keys(desc)
    if desc.shape[0] > dense_limit:
        s1_vals, s1_idx = _stage1_candidates_tiled(keys, top_m,
                                                   min_separation, tile)
    else:
        s1_vals, s1_idx = _stage1_candidates(keys, top_m, min_separation)
    cand = desc[s1_idx.reshape(-1)]                            # [F*M, R, S]
    query = torch.repeat_interleave(desc, top_m, dim=0)        # [F*M, R, S]
    sim, shift = sc_correlate(cand, query, min_overlap)        # i vs j frame
    return (torch.isfinite(s1_vals).reshape(-1), s1_idx.reshape(-1),
            sim, shift)


def propose_candidates(desc: torch.Tensor, cfg: ScanContextConfig
                       ) -> List[dict]:
    """Rank revisit candidates by descriptor similarity.

    Returns at most ``cfg.max_candidates`` dicts {i, j, sim, yaw} sorted by
    descending similarity, deduplicated to one candidate per query frame j.
    """
    F = int(desc.shape[0])
    if F <= cfg.min_separation:
        return []
    # top-k needs k <= F.
    top_m = min(cfg.top_m, F)
    ok, ii, sim, shift = _stage2_scores(
        desc, top_m, cfg.min_separation, cfg.min_overlap,
        dense_limit=cfg.stage1_dense_limit, tile=cfg.stage1_tile)
    yaw = shift_to_yaw(shift, cfg.n_sectors)
    ok, ii, sim, yaw = device_get((ok, ii, sim, yaw))
    jj = np.repeat(np.arange(F), top_m)

    order = np.argsort(-sim)
    out, used_j = [], set()
    for k in order:
        if not ok[k] or sim[k] < cfg.sim_threshold:
            continue
        j = int(jj[k])
        if j in used_j:
            continue
        used_j.add(j)
        out.append({"i": int(ii[k]), "j": j, "sim": float(sim[k]),
                    "yaw": float(yaw[k])})
        if len(out) >= cfg.max_candidates:
            break
    return out


# ---------------------------------------------------------------------------
# End-to-end: retrieve + ICP-verify
# ---------------------------------------------------------------------------

def find_loop_closures_sc(points: torch.Tensor, valid: torch.Tensor,
                          poses: Optional[np.ndarray] = None,
                          cfg: LoopClosureConfig = LoopClosureConfig(),
                          sc: ScanContextConfig = ScanContextConfig()
                          ) -> List[dict]:
    """Descriptor-retrieved, ICP-verified loop closures.

    Same output contract as ``loopclosure.find_loop_closures`` ({i, j,
    delta, rmse, inliers} dicts, plus the retrieval's ``sim``).  ``poses``
    is optional and only seeds one of the two ICP inits and the
    odometry-consistency gate.

    Each candidate is verified from two initialisations -- (0, 0, yaw_sc)
    and the estimated relative transform (the identity without poses) --
    in one batched ICP; the init with more inliers (ties: lower RMSE) wins.
    """
    sc = dataclasses.replace(sc, min_separation=max(sc.min_separation,
                                                    cfg.min_separation),
                             max_candidates=cfg.max_candidates)
    desc = build_descriptors(points, valid, sc)
    cands = propose_candidates(desc, sc)
    if not cands:
        return []

    ii = np.array([c["i"] for c in cands])
    jj = np.array([c["j"] for c in cands])
    init_sc = np.zeros((len(cands), 3), np.float32)
    init_sc[:, 2] = [c["yaw"] for c in cands]
    if poses is not None:
        poses = np.asarray(poses)
        init_pose = np.stack([_relative_pose(poses[a], poses[b])
                              for a, b in zip(ii, jj)]).astype(np.float32)
    else:
        init_pose = np.zeros((len(cands), 3), np.float32)
    inits = np.stack([init_sc, init_pose], axis=1)             # [P, 2, 3]
    deltas, rmses, inliers = _icp_pairs(points, valid, ii, jj, inits, cfg)

    # Pick the better init per pair: most inliers, then lowest RMSE (the
    # first on a tie, as np.argmax takes).
    pick = np.argmax(inliers - 1e-4 * rmses, axis=1)
    take = np.arange(len(cands))
    deltas, rmses, inliers = (deltas[take, pick], rmses[take, pick],
                              inliers[take, pick])

    # Odometry-consistency gate: an aliased "revisit" disagrees with the
    # integrated relative pose by a full pattern period, genuine drift only
    # by the accumulated error.
    if poses is not None:
        arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
            np.diff(poses[:, :2], axis=0), axis=1))])
        path_len = arc[jj] - arc[ii]
        disagree = np.linalg.norm(deltas[:, :2] - init_pose[:, :2], axis=1)
        odo_ok = disagree <= cfg.odo_gate_abs + cfg.odo_gate_frac * path_len
    else:
        odo_ok = np.ones(len(cands), bool)

    out = []
    for k, c in enumerate(cands):
        if (inliers[k] >= cfg.min_inliers and rmses[k] <= cfg.max_rmse
                and odo_ok[k]):
            out.append({"i": int(ii[k]), "j": int(jj[k]),
                        "delta": deltas[k], "rmse": float(rmses[k]),
                        "inliers": int(inliers[k]), "sim": c["sim"]})
    return out
