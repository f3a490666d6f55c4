"""Scan-free temporal angle smoothing over a whole sequence.

Counterpart of ``radar_slam_tpu/aoa/smoothing.py:smooth_windowed``: a track
is a backward chain of same-key detections (key = range_bin * D +
doppler_bin) with frame gaps <= track_max_age + 1, and each detection is
smoothed over the last ``temporal_window`` raw measurements of its chain
(confidence-weighted circular mean blended with the previous raw angle).
Exact against the reference's slot-table scan while the table never evicts
a fresh track (capacity >= live tracks).  The slot-table scan itself
(``update``) belongs to the sequential pipelines and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from radar_slam_tpu_torch.core.config import AoAConfig


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
