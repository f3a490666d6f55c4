"""Temporal angle smoothing: the slot-table smoother and its scan-free form.

Counterpart of ``radar_slam_tpu/aoa/smoothing.py``.  A track is keyed by
its cell (key = range_bin * D + doppler_bin); each detection is smoothed
over the last ``temporal_window`` raw measurements of its track
(confidence-weighted circular mean blended with the previous raw angle).

- :class:`SmootherState` / :func:`init_state` / :func:`update`: the
  sequential drivers' fixed-capacity slot table, one frame per call --
  per-slot ring buffers, free slots then the stalest allocated first, stale
  tracks (older than ``track_max_age``) unmatchable.
- :func:`smooth_windowed`: the batched drivers' form over a whole sequence,
  a backward chain of same-key detections with frame gaps <=
  track_max_age + 1.  Exact against :func:`update` while the table never
  evicts a fresh track (capacity >= live tracks).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from radar_slam_tpu_torch.core.config import AoAConfig


class SmootherState(NamedTuple):
    """The slot table (capacity Cs slots, window W)."""

    keys: torch.Tensor     # [Cs] int32, -1 = free slot
    angles: torch.Tensor   # [Cs, W] float32 ring buffer [deg]
    confs: torch.Tensor    # [Cs, W] float32 ring buffer
    count: torch.Tensor    # [Cs] int32 measurements ever written to the slot
    age: torch.Tensor      # [Cs] int32 frames since the last update


def init_state(aoa: AoAConfig, device=None) -> SmootherState:
    Cs, W = aoa.track_capacity, aoa.temporal_window
    return SmootherState(
        keys=torch.full((Cs,), -1, dtype=torch.int32, device=device),
        angles=torch.zeros((Cs, W), dtype=torch.float32, device=device),
        confs=torch.zeros((Cs, W), dtype=torch.float32, device=device),
        count=torch.zeros((Cs,), dtype=torch.int32, device=device),
        age=torch.zeros((Cs,), dtype=torch.int32, device=device))


def _window_smooth(angles: torch.Tensor, confs: torch.Tensor,
                   count: torch.Tensor, write_pos: torch.Tensor,
                   smoothing_factor: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothed (angle_deg, conf) per row [K] of ring buffers [K, W] holding
    ``count`` valid entries, the newest at ``write_pos``."""
    W = angles.shape[-1]
    idx = torch.arange(W, device=angles.device)[None, :]
    valid = idx < count[:, None]
    weights = torch.where(valid, confs, 0.0)
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    n_valid = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
    weights = torch.where(wsum > 0, weights / torch.clamp(wsum, min=1e-30),
                          valid / n_valid)
    ang_rad = torch.deg2rad(angles)
    mean_cos = torch.sum(weights * torch.cos(ang_rad), dim=-1)
    mean_sin = torch.sum(weights * torch.sin(ang_rad), dim=-1)
    circ_deg = torch.rad2deg(torch.atan2(mean_sin, mean_cos))

    # The previous raw angle is the entry before the newest.
    write_pos = write_pos.to(torch.int64)
    prev_pos = torch.remainder(write_pos - 1, W)
    prev = torch.gather(angles, -1, prev_pos[:, None])[:, 0]
    blended = smoothing_factor * circ_deg + (1.0 - smoothing_factor) * prev
    conf = torch.sum(torch.where(valid, confs, 0.0), dim=-1) / n_valid[:, 0]

    newest = torch.gather(angles, -1, write_pos[:, None])[:, 0]
    newest_conf = torch.gather(confs, -1, write_pos[:, None])[:, 0]
    single = count <= 1
    return (torch.where(single, newest, blended),
            torch.where(single, newest_conf, conf))


def update(state: SmootherState, det_keys: torch.Tensor,
           angles_deg: torch.Tensor, confidences: torch.Tensor,
           valid: torch.Tensor, aoa: AoAConfig
           ) -> Tuple[SmootherState, torch.Tensor, torch.Tensor]:
    """Ingest one frame's detections [K]; returns (new state, smoothed
    angles [K], smoothed confidences [K]).

    A valid detection continues the fresh track of its key (the first
    such slot) or takes a new slot: free slots first, then the stalest,
    never a slot matched this frame.  The allocation order is a stable
    descending sort of the slots' priority, ``lax.top_k``'s tie order (most
    slots tie while the table is empty).  Rows that write nothing go to a
    padding slot that is cut off, as the reference's ``mode="drop"``
    scatters drop them."""
    Cs = state.keys.shape[0]
    W = state.angles.shape[1]
    K = det_keys.shape[0]
    dev = det_keys.device
    det_keys = det_keys.to(torch.int32)

    fresh = state.age <= aoa.track_max_age
    key_eq = ((state.keys[None, :] == det_keys[:, None])
              & (state.keys[None, :] >= 0) & fresh[None, :])    # [K, Cs]
    matched = torch.any(key_eq, dim=1) & valid
    match_slot = torch.argmax(key_eq.to(torch.uint8), dim=1)     # first true

    slot_matched = torch.any(key_eq & valid[:, None], dim=0)     # [Cs]
    priority = torch.where(state.keys < 0, 1 << 30, state.age)
    priority = torch.where(slot_matched, -1, priority)
    evict_order = torch.sort(priority, descending=True,
                             stable=True).indices[:min(K, Cs)]

    need_alloc = valid & ~matched
    alloc_rank = torch.cumsum(need_alloc.to(torch.int64), dim=0) - 1
    alloc_slot = evict_order[torch.clamp(alloc_rank, 0,
                                         evict_order.shape[0] - 1)]
    slot = torch.where(matched, match_slot, alloc_slot)          # [K]
    slot_w = torch.where(valid, slot, Cs)                        # Cs: dropped

    new_count = torch.where(matched, state.count[slot] + 1, 1)
    pos = torch.remainder(new_count - 1, W).to(torch.int64)

    def scatter(table, values, fill_pos=None):
        pad = torch.cat([table, table[:1]])          # row Cs takes the drops
        if fill_pos is None:
            pad[slot_w] = values.to(table.dtype)
        else:
            pad[slot_w, fill_pos] = values.to(table.dtype)
        return pad[:Cs]

    keys = scatter(state.keys, det_keys)
    count = scatter(state.count, torch.clamp(new_count, max=2 ** 30))
    angles = scatter(state.angles, angles_deg, pos)
    confs = scatter(state.confs, confidences, pos)
    age = scatter(state.age + 1, torch.zeros(K, dtype=torch.int32,
                                             device=dev))

    rows = torch.clamp(slot, 0, Cs - 1)
    sm_angle, sm_conf = _window_smooth(
        angles[rows], confs[rows], torch.clamp(count[rows], max=W), pos,
        aoa.smoothing_factor)
    sm_angle = torch.where(valid, sm_angle, angles_deg)
    sm_conf = torch.where(valid, sm_conf, confidences)
    return (SmootherState(keys=keys, angles=angles, confs=confs,
                          count=count, age=age), sm_angle, sm_conf)


def smooth_windowed(det_keys: torch.Tensor, angles_deg: torch.Tensor,
                    confidences: torch.Tensor, valid: torch.Tensor,
                    aoa: AoAConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args: det_keys [F, K] int track keys; angles_deg, confidences
    [F, K] raw measurements; valid [F, K] participating detections.

    Returns (smoothed_angles_deg [F, K], smoothed_confs [F, K])."""
    F, K = det_keys.shape
    L = aoa.track_max_age + 1            # max frame gap within a track
    W = aoa.temporal_window
    dev = det_keys.device

    key_v = torch.where(valid, det_keys.to(torch.int64), -1)

    # --- predecessor pointers: nearest same-key detection within L frames
    pred_f = torch.zeros((F, K), dtype=torch.int64, device=dev)
    pred_j = torch.zeros((F, K), dtype=torch.int64, device=dev)
    found = torch.zeros((F, K), dtype=torch.bool, device=dev)
    frame_idx = torch.arange(F, device=dev)[:, None]
    for g in range(1, L + 1):
        prev_keys = torch.cat(
            [torch.full((min(g, F), K), -2, dtype=torch.int64, device=dev),
             key_v[:-g]], dim=0)[:F]
        eq = ((key_v[:, :, None] == prev_keys[:, None, :])
              & (key_v >= 0)[:, :, None])
        m = torch.any(eq, dim=-1)
        j = torch.argmax(eq.to(torch.uint8), dim=-1)   # first match
        new = m & ~found
        pred_f = torch.where(new, frame_idx - g, pred_f)
        pred_j = torch.where(new, j, pred_j)
        found = found | new

    # --- follow the chain W-1 hops, gathering raw (angle, conf) entries
    entries_ang = [angles_deg]           # newest first
    entries_conf = [confidences]
    entries_ok = [torch.ones((F, K), dtype=torch.bool, device=dev)]
    cur_f, cur_j, cur_ok = pred_f, pred_j, found
    for w in range(1, W):
        cf = torch.clamp(cur_f, 0, F - 1)
        entries_ang.append(angles_deg[cf, cur_j])
        entries_conf.append(confidences[cf, cur_j])
        entries_ok.append(cur_ok)
        if w < W - 1:
            cur_ok = cur_ok & found[cf, cur_j]
            cur_f, cur_j = pred_f[cf, cur_j], pred_j[cf, cur_j]

    ang = torch.stack(entries_ang, dim=-1)       # [F, K, W] newest first
    cnf = torch.stack(entries_conf, dim=-1)
    ok = torch.stack(entries_ok, dim=-1)

    # --- the reference's _window_smooth math
    weights = torch.where(ok, cnf, 0.0)
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    n_ok = torch.clamp(torch.sum(ok, dim=-1, keepdim=True), min=1)
    weights = torch.where(wsum > 0,
                          weights / torch.clamp(wsum, min=1e-30),
                          ok / n_ok)
    ang_rad = torch.deg2rad(ang)
    circ_deg = torch.rad2deg(torch.atan2(
        torch.sum(weights * torch.sin(ang_rad), dim=-1),
        torch.sum(weights * torch.cos(ang_rad), dim=-1)))
    prev = ang[..., 1]                           # previous raw measurement
    blended = (aoa.smoothing_factor * circ_deg
               + (1.0 - aoa.smoothing_factor) * prev)
    conf = torch.sum(torch.where(ok, cnf, 0.0), dim=-1) / n_ok[..., 0]

    single = ~found                              # count <= 1
    sm_angle = torch.where(single, angles_deg, blended)
    sm_conf = torch.where(single, confidences, conf)
    sm_angle = torch.where(valid, sm_angle, angles_deg)
    sm_conf = torch.where(valid, sm_conf, confidences)
    return sm_angle, sm_conf
