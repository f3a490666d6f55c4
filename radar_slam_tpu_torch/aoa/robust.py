"""The robust per-frame AoA stage of the sequential drivers.

Counterpart of ``radar_slam_tpu/aoa/robust.py``: power filter and
``max_targets`` truncation as masks, MDL model order from the rank-1
spectrum, angles (beamforming, MUSIC or ESPRIT), confidence, temporal
smoothing through the slot table (``smoothing.update``), and the
reliability gate.  Detections
carry the leading frame axis [F, K]; with smoothing the frames go through
the slot table one after another, in order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radar_slam_tpu_torch.aoa import confidence as conf_mod
from radar_slam_tpu_torch.aoa import estimators, smoothing
from radar_slam_tpu_torch.core.config import AoAConfig, RadarConfig
from radar_slam_tpu_torch.core.types import Detections, Targets
from radar_slam_tpu_torch.signal.detect import extract_spatial_signatures


def process_targets_robust(rds: Optional[torch.Tensor],
                           detections: Detections,
                           state: smoothing.SmootherState,
                           cfg: RadarConfig, aoa: AoAConfig,
                           method: str = "beamforming", smooth: bool = True,
                           signatures: Optional[torch.Tensor] = None,
                           doppler_bins: Optional[int] = None
                           ) -> Tuple[Targets, smoothing.SmootherState]:
    """Targets [F, K] and the new smoother state from detections [F, K].

    ``rds`` [F, A, R, D] may be None when ``signatures`` [F, K, A] are
    given (the fused paths); ``doppler_bins`` must then be given, since it
    keys the smoother's tracks (key = range_bin * D + doppler_bin)."""
    K = detections.range_bin.shape[-1]
    D = rds.shape[-1] if rds is not None else doppler_bins
    dev = detections.range_bin.device
    keep = (detections.valid
            & (detections.power_db > aoa.power_filter_db)
            & (torch.arange(K, device=dev) < aoa.max_targets))
    if signatures is None:
        signatures = extract_spatial_signatures(rds, detections)

    eigvals = estimators.rank1_eigenvalues(signatures)
    num_sources, is_multipath, _ = conf_mod.mdl_model_order(eigvals)
    angles_deg, el_deg = estimators.locate_angles_2d(
        signatures, cfg, aoa, method=method, num_sources=num_sources)
    conf = conf_mod.angle_confidence(signatures, angles_deg, cfg, el_deg)

    if smooth:
        det_keys = detections.range_bin * D + detections.doppler_bin
        ang_rows, conf_rows = [], []
        for f in range(det_keys.shape[0]):
            state, a_f, c_f = smoothing.update(
                state, det_keys[f], angles_deg[f], conf[f], keep[f], aoa)
            ang_rows.append(a_f)
            conf_rows.append(c_f)
        angles_deg = torch.stack(ang_rows)
        conf = torch.stack(conf_rows)

    is_reliable = keep & (conf >= aoa.confidence_threshold) & ~is_multipath
    targets = Targets(
        range_bin=detections.range_bin, doppler_bin=detections.doppler_bin,
        range_m=detections.range_m, doppler_hz=detections.doppler_hz,
        vr_mps=detections.vr_mps, power_db=detections.power_db,
        azimuth_rad=torch.deg2rad(angles_deg), confidence=conf,
        num_sources=num_sources, is_multipath=is_multipath,
        is_reliable=is_reliable, spatial_signature=signatures, valid=keep,
        elevation_rad=torch.deg2rad(el_deg))
    return targets, state


def process_targets(rds: torch.Tensor, detections: Detections,
                    cfg: RadarConfig, aoa: AoAConfig,
                    method: str = "music") -> Targets:
    """The basic (non-robust) AoA stage: every valid detection is a
    target, no smoothing and no confidence gate."""
    targets, _ = process_targets_robust(
        rds, detections, smoothing.init_state(aoa, rds.device), cfg, aoa,
        method=method, smooth=False)
    return targets._replace(is_reliable=targets.valid)
