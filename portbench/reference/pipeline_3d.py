"""The 3-D reference driver: ``process_sequence_batched`` on a planar array
(URA), worked out again.

Phase A is :func:`portbench.reference.frontend.front_end` as it is (K1's
function is generic over the elements A = A_el * A_az; the frozen
synthesis already turns a scatterer's elevation into its antenna phases),
in blocks of :data:`BLOCK` frames; phase B is
:mod:`portbench.reference.estimation` with the URA's joint estimation and
targets of :mod:`portbench.reference.estimation_3d`.  Nothing here imports
the program or JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import estimation as est
from portbench.reference import estimation_3d as est3
from portbench.reference import frontend
from portbench.reference.pipeline import _rows, _sequence_solve, _take

BLOCK = 128       # frames of phase A at a time (A = 32: ~8 GB in float64)


class Result3D(NamedTuple):
    rows: np.ndarray            # [F, 13] per-frame numbers
    target_xy: np.ndarray       # [F, K, 2]
    target_valid: np.ndarray    # [F, K]
    target_z: np.ndarray        # [F, K] heights


def features(scatterers, seeds: torch.Tensor, cfg, precision: str):
    """Per-frame URA AoA features (``estimation_3d.aoa_features``) of
    frames [F, S_max], phase A in blocks of :data:`BLOCK` frames."""
    prec = est.PRECISIONS[precision]
    dev = seeds.device
    F = seeds.shape[0]
    parts = []
    for i in range(0, F, BLOCK):
        fe = frontend.front_end(_take(scatterers, slice(i, i + BLOCK)),
                                seeds[i:i + BLOCK], cfg, precision)
        p_lin, r_bin, d_bin, values, sigs = [x.cpu().numpy() for x in fe]
        del fe
        det = est.detections(p_lin, r_bin, d_bin, values, cfg, prec)
        parts.append((det, sigs))
    det = {k: np.concatenate([d[k] for d, _ in parts]) for k in parts[0][0]}
    sigs = np.concatenate([s for _, s in parts])
    return est3.aoa_features(det, sigs, cfg, prec, dev)


def batched_3d(scatterers, seeds: torch.Tensor, cfg,
               precision: str = "float64") -> Result3D:
    """``process_sequence_batched`` of frames [F, S_max] with
    ``elevation_rad``, noise seeds [F]: the batched rows [pose (3),
    velocity (3), angular velocity (3), success, detections, reliable
    targets, associations], the targets' (x, y), validity and heights."""
    prec = est.PRECISIONS[precision]
    feat = features(scatterers, seeds, cfg, precision)
    az, conf = est.smooth_sequence(feat["key"], feat["az_deg"],
                                   feat["conf"], feat["kept"], cfg.aoa)
    tg = est3.targets(feat, az, conf, cfg, prec)
    x, success, n = _sequence_solve(tg, cfg, prec)
    pose = est.pose_sequence(x, success, cfg.frame_dt)
    return Result3D(_rows(pose, x, success, feat["valid"].sum(-1),
                          tg["reliable"].sum(-1), n),
                    tg["pos"][..., :2], tg["ok"].copy(), tg["pos"][..., 2])
