"""Cross-frame target association, batched.

Counterpart of ``radar_slam_tpu/motion/associate.py:associate_targets``
over a leading frame axis.  ``association_method="mutual"``: current
target i and previous target j match iff each is the other's nearest
(reliable, gated, same-group) neighbour under the cartesian or the polar
metric.  ``"greedy"``: the current targets claim in power order, each the
nearest previous target no earlier one claimed, inside the gate -- K claim
steps over the [F, K, K] distances with a used mask, where the reference
scans.  Also computes what the velocity solver needs per match: the
temporal phase difference on reference antenna 0, the apparent velocity,
the match weight and the line of sight (from the vehicle origin, or from
each target's own sensor on a mounted rig).
"""

from __future__ import annotations

from typing import Optional

import torch

from radar_slam_tpu_torch.core.config import VelocityConfig
from radar_slam_tpu_torch.core.geometry import direction_vector
from radar_slam_tpu_torch.core.types import Associations, Targets


_BIG = 1e9    # the distance of a pair that may not match


def _greedy_claims(dist: torch.Tensor, cur_ok: torch.Tensor, gate: float):
    """The reference's greedy scan over distances [F, K, K] (current x
    previous, ``_BIG`` where a pair may not match): current target i, in
    order, takes the nearest previous target no earlier hit claimed
    (``argmin``'s first minimum), a hit when i is reliable and that
    distance is inside ``gate``.  Returns (j [F, K], its distance, hit)."""
    F, K, _ = dist.shape
    cols = torch.arange(K, device=dist.device)
    used = torch.zeros((F, K), dtype=torch.bool, device=dist.device)
    js, bests, hits = [], [], []
    for i in range(K):
        d = torch.where(used, _BIG, dist[:, i])
        j = torch.argmin(d, dim=1)                                 # [F]
        best = torch.gather(d, 1, j[:, None])[:, 0]
        hit = cur_ok[:, i] & (best < gate)
        used = used | ((cols[None, :] == j[:, None]) & hit[:, None])
        js.append(j)
        bests.append(best)
        hits.append(hit)
    return (torch.stack(js, dim=1), torch.stack(bests, dim=1),
            torch.stack(hits, dim=1))


def associate_targets(current: Targets, previous: Targets, dt: float,
                      cfg: VelocityConfig, metric: str = "cartesian",
                      sensor_pos: Optional[torch.Tensor] = None,
                      group: Optional[torch.Tensor] = None) -> Associations:
    """Gated association between two target sets [F, K], by
    ``cfg.association_method`` ("mutual" or "greedy", module docstring).

    ``metric``: "cartesian", the distance between (x, y) positions, or
    "polar", sqrt(d_range^2 + d_azimuth^2) in metres and radians.
    ``sensor_pos`` [K, 3]: the vehicle-frame origin of the sensor that
    observed each current target; the line of sight is then
    (position - sensor_pos) normalized, as a mounted radar needs.
    ``group`` [K] int32: a block id shared by both frames' layouts;
    matches stay within equal ids (one physical sensor)."""
    if cfg.association_method not in ("mutual", "greedy"):
        raise ValueError(
            f"Unknown association method: {cfg.association_method}")
    F, K = current.range_m.shape
    dev = current.range_m.device

    cur_ok = current.valid & current.is_reliable
    prev_ok = previous.valid & previous.is_reliable
    cur_pos = current.position
    prev_pos = previous.position
    if metric == "cartesian":
        diff = cur_pos[:, :, None, :2] - prev_pos[:, None, :, :2]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)  # [F, K, K]
    elif metric == "polar":
        dr = current.range_m[:, :, None] - previous.range_m[:, None, :]
        da = current.azimuth_rad[:, :, None] - previous.azimuth_rad[:, None, :]
        dist = torch.sqrt(dr * dr + da * da)
    else:
        raise ValueError(f"Unknown association metric: {metric}")
    ok = cur_ok[:, :, None] & prev_ok[:, None, :]
    if group is not None:
        ok = ok & (group[:, None] == group[None, :])
    dist = torch.where(ok, dist, _BIG)

    if cfg.association_method == "greedy":
        j_of_i, best_dist, hit = _greedy_claims(dist, cur_ok,
                                                cfg.association_gate)
    else:
        j_of_i = torch.argmin(dist, dim=2)                       # [F, K]
        i_of_j = torch.argmin(dist, dim=1)                       # [F, K]
        best_dist = torch.amin(dist, dim=2)
        mutual = (torch.gather(i_of_j, 1, j_of_i)
                  == torch.arange(K, device=dev)[None, :])
        hit = cur_ok & mutual & (best_dist < cfg.association_gate)

    # Previous-frame lookups at prev_idx: signature on antenna 0, position,
    # confidence.
    s_prev = torch.gather(previous.spatial_signature[..., 0], 1, j_of_i)
    p_prev = torch.gather(prev_pos, 1, j_of_i[..., None].expand(F, K, 3))
    c_prev = torch.gather(previous.confidence, 1, j_of_i)
    s_cur = current.spatial_signature[..., 0]
    phase = torch.angle(s_cur * s_prev.conj())

    dt = max(float(dt), 1e-6)
    apparent_v = (cur_pos - p_prev) / dt

    if sensor_pos is None:
        el = (current.elevation_rad if current.elevation_rad is not None
              else torch.zeros_like(current.azimuth_rad))
        direction = direction_vector(current.azimuth_rad, el)
    else:
        rel = cur_pos - sensor_pos
        direction = rel / torch.clamp(
            torch.linalg.vector_norm(rel, dim=-1, keepdim=True), min=1e-6)
    return Associations(
        prev_index=j_of_i.to(torch.int32),
        distance=torch.where(hit, best_dist, 0.0),
        temporal_phase_diff=torch.where(hit, phase, 0.0),
        position=cur_pos,
        direction=direction,
        vr_mps=current.vr_mps,
        apparent_velocity=torch.where(hit[..., None], apparent_v, 0.0),
        weight=torch.where(hit, current.confidence * c_prev, 0.0),
        valid=hit,
    )
