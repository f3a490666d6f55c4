"""The reference driver of the three-dispatch route:
``process_sequence_batched`` at OS-CFAR (or ``frontend_one_pass=False``)
on the fused, cube-free front end, worked out again.

Phase A is :func:`portbench.reference.frontend_three_dispatch.front_end`
(K4's power map, the detection and K5's signatures in PyTorch on the card)
in blocks of :data:`BLOCK` frames, so that one 8,192-frame call fits;
phase B is :mod:`portbench.reference.estimation` as the one-pass drivers
run it.  Nothing here imports the program or JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import estimation as est
from portbench.reference import frontend_three_dispatch as frontend
from portbench.reference.pipeline import Result, _rows, _sequence_solve, _take

BLOCK = 512       # frames of phase A at a time (~6 GB at float64)


def features(scatterers, seeds: torch.Tensor, cfg, precision: str):
    """Per-frame AoA features (``estimation.aoa_features``) of frames
    [F, S_max], phase A in blocks of :data:`BLOCK` frames."""
    prec = est.PRECISIONS[precision]
    F = seeds.shape[0]
    parts = []
    for i in range(0, F, BLOCK):
        fe = frontend.front_end(_take(scatterers, slice(i, i + BLOCK)),
                                seeds[i:i + BLOCK], cfg, precision)
        p_lin, r_bin, d_bin, values, sigs = [x.cpu().numpy() for x in fe]
        del fe
        det = est.detections(p_lin, r_bin, d_bin, values, cfg, prec)
        parts.append(est.aoa_features(det, sigs, cfg, prec))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def batched(scatterers, seeds: torch.Tensor, cfg,
            precision: str = "float64") -> Result:
    """``process_sequence_batched`` of frames [F, S_max], noise seeds [F]
    on the three-dispatch route: rows [pose (3), velocity (3), angular
    velocity (3), success, detections, reliable targets, associations],
    the targets' (x, y) and validity."""
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
