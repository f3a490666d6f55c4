"""The reference drivers: the frames of a timed call, worked out again.

Phase A is :mod:`portbench.reference.frontend` (K1's function, PyTorch on
the card, in blocks of frames); phase B is :mod:`portbench.reference.
estimation` (NumPy on the host).  Each driver returns what the program's
counterpart hands the host, as a :class:`Result`:

- :func:`batched`: ``process_sequence_batched`` (scatterers [F, S_max],
  seeds [F]);
- :func:`rig_batched`: ``process_sequence_rig_batched`` and its prefetch
  driver (scatterers [F, B, S_max] of the mounted sensors ``rig`` (x, y,
  yaw), seeds [F, B]);
- :func:`stream`: ``StreamingAnalyzer.process_frame`` frame after frame
  from a fresh analyzer (frame i drawn with noise seed i).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import estimation as est
from portbench.reference import frontend

BLOCK = 512       # frames of phase A at a time


class Result(NamedTuple):
    rows: np.ndarray                   # [F, n] per-frame numbers
    target_xy: Optional[np.ndarray]    # [F, N, 2]
    target_valid: Optional[np.ndarray]  # [F, N]


def _take(batch, sl):
    return type(batch)(*[None if x is None else x[sl] for x in batch])


def features(scatterers, seeds: torch.Tensor, cfg, precision: str):
    """Per-frame AoA features (``estimation.aoa_features``) of frames
    [F, S_max], phase A in blocks of :data:`BLOCK` frames."""
    prec = est.PRECISIONS[precision]
    F = seeds.shape[0]
    parts = []
    for i in range(0, F, BLOCK):
        fe = frontend.front_end(_take(scatterers, slice(i, i + BLOCK)),
                                seeds[i:i + BLOCK], cfg, precision)
        host = [x.cpu().numpy() for x in fe]
        del fe
        p_lin, r_bin, d_bin, values, sigs = host
        det = est.detections(p_lin, r_bin, d_bin, values, cfg, prec)
        parts.append(est.aoa_features(det, sigs, cfg, prec))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _rows(pose, x, success, *counts):
    return np.concatenate(
        [pose, x, success[:, None]] + [c[:, None] for c in counts],
        axis=-1).astype(np.float64)


def batched(scatterers, seeds: torch.Tensor, cfg,
            precision: str = "float64") -> Result:
    """``process_sequence_batched`` of frames [F, S_max], noise seeds [F]:
    rows [pose (3), velocity (3), angular velocity (3), success,
    detections, reliable targets, associations]."""
    prec = est.PRECISIONS[precision]
    feat = features(scatterers, seeds, cfg, precision)
    az, conf = est.smooth_sequence(feat["key"], feat["az_deg"],
                                   feat["conf"], feat["kept"], cfg.aoa)
    tg = est.targets(feat, az, conf, cfg, prec)
    x, success, n = _sequence_solve(tg, cfg, prec)
    pose = est.pose_sequence(x, success, cfg.frame_dt)
    return Result(_rows(pose, x, success, feat["valid"].sum(-1),
                        tg["reliable"].sum(-1), n),
                  tg["pos"][..., :2], tg["ok"].copy())


def _sequence_solve(tg, cfg, prec, group=None):
    """Association with the frame before, and the solve, over a sequence."""
    F = tg["ok"].shape[0]
    prev = {k: np.concatenate([v[:1], v[:-1]]) for k, v in tg.items()}
    assoc = est.associate(tg, prev, np.arange(F) > 0, cfg, prec, group)
    return est.solve(assoc, cfg, prec)


def rig_batched(scatterers, seeds: torch.Tensor, cfg, rig,
                precision: str = "float64") -> Result:
    """``process_sequence_rig_batched`` of per-sensor frames [F, B, S_max],
    noise seeds [F, B]: the batched rows, detections counting the kept
    ones of every sensor; targets [F, B*K] in the vehicle frame."""
    prec = est.PRECISIONS[precision]
    F, B = seeds.shape
    flat = type(scatterers)(*[None if x is None else x.flatten(0, 1)
                              for x in scatterers])
    feat = features(flat, seeds.reshape(-1), cfg, precision)
    feat = {k: v.reshape(F, B, *v.shape[1:]) for k, v in feat.items()}
    per = []
    for b in range(B):
        fb = {k: v[:, b] for k, v in feat.items()}
        az, conf = est.smooth_sequence(fb["key"], fb["az_deg"], fb["conf"],
                                       fb["kept"], cfg.aoa)
        per.append(est.targets(fb, az, conf, cfg, prec, mount=rig[b]))
    tg = {k: np.concatenate([p[k] for p in per], axis=1) for k in per[0]}
    K = feat["kept"].shape[-1]
    group = np.repeat(np.arange(B), K)
    x, success, n = _sequence_solve(tg, cfg, prec, group)
    pose = est.pose_sequence(x, success, cfg.frame_dt)
    return Result(_rows(pose, x, success, feat["kept"].sum((1, 2)),
                        tg["reliable"].sum(-1), n),
                  tg["pos"][..., :2], tg["ok"].copy())


def stream(scatterers, cfg, precision: str = "float64") -> Result:
    """The host numbers of ``StreamingAnalyzer.process_frame`` over frames
    [F, S_max] from a fresh analyzer, frame i with noise seed i: rows
    [pose (3), velocity (3), angular velocity (3), success, reliable
    targets, associations].

    Each step continues the analyzer's state: the table of tracks, the
    previous frame's targets (matched only where it had a kept one), the
    last successful motion (the solve's prior, and what a failed step
    reports and coasts on) and the pose."""
    prec = est.PRECISIONS[precision]
    F = scatterers.range_m.shape[0]
    seeds = torch.arange(F, dtype=torch.int32,
                         device=scatterers.range_m.device)
    feat = features(scatterers, seeds, cfg, precision)
    table = est.SlotTable(cfg.aoa)
    prev, prev_any = None, False
    motion = np.zeros(6)
    pose = np.zeros(3)
    rows = []
    for f in range(F):
        ff = {k: v[f:f + 1] for k, v in feat.items()}
        az, conf = table.step(ff["key"][0], ff["az_deg"][0], ff["conf"][0],
                              ff["kept"][0])
        tg = est.targets(ff, az[None], conf[None], cfg, prec)
        if prev is None:
            prev = {k: np.zeros_like(v) for k, v in tg.items()}
        assoc = est.associate(tg, prev, np.array([prev_any]), cfg, prec)
        x, success, n = est.solve(assoc, cfg, prec, motion[None])
        x = x[0].astype(np.float64)
        if cfg.pose.coast_on_failure or success[0]:
            pose = est.pose_step(pose, x, cfg.frame_dt)
        if success[0]:
            motion = x
        rows.append(np.concatenate([pose, x, [float(success[0]),
                                              float(tg["reliable"].sum()),
                                              float(n[0])]]))
        prev, prev_any = tg, bool(tg["kept"].any())
    return Result(np.stack(rows), None, None)
