"""Vectorized confidence scoring + MDL model order.

Counterpart of ``radar_slam_tpu/aoa/confidence.py``; leading axes
(frames, detections) broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import RadarConfig
from radar_slam_tpu_torch.core.geometry import (steering_vector,
                                                ura_steering_vector,
                                                wrap_angle)


def _percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=-1)`` with linear interpolation, in the
    reference's float32 arithmetic: rank q/100 (n - 1), value
    low (1 - w) + high w."""
    n = x.shape[-1]
    xs = torch.sort(x, dim=-1).values
    rank = np.float32(q) / np.float32(100.0) * np.float32(n - 1)
    hw = np.float32(rank - np.floor(rank))
    lw = np.float32(1.0) - hw
    i_lo = int(np.clip(np.floor(rank), 0, n - 1))
    i_hi = int(np.clip(np.ceil(rank), 0, n - 1))
    return xs[..., i_lo] * float(lw) + xs[..., i_hi] * float(hw)


def angle_confidence(signatures: torch.Tensor, angles_deg: torch.Tensor,
                     cfg: RadarConfig, el_deg=None) -> torch.Tensor:
    """Confidence scores [..., K] in [0, 1]: 0.4 steering correlation +
    0.3 phase consistency + 0.3 SNR proxy; on a URA against the steering
    vector at (azimuth, ``el_deg``), elevation 0 where None."""
    az_rad = torch.deg2rad(angles_deg)
    if cfg.num_antennas_el > 1:
        el_rad = (torch.deg2rad(el_deg) if el_deg is not None
                  else torch.zeros_like(az_rad))
        sv = ura_steering_vector(az_rad, el_rad, cfg.num_antennas,
                                 cfg.num_antennas_el, cfg.spacing,
                                 cfg.spacing_el, cfg.lambda_c)
    else:
        sv = steering_vector(az_rad, cfg.num_antennas, cfg.spacing,
                             cfg.lambda_c)

    sig_power = torch.sum(signatures.abs() ** 2, dim=-1)
    corr = torch.sum(sv.conj() * signatures, dim=-1).abs()
    norm_corr = torch.where(
        sig_power > 0, corr / torch.sqrt(torch.clamp(sig_power, min=1e-30)),
        0.0)

    phase_err = torch.mean(
        wrap_angle(torch.angle(signatures) - torch.angle(sv)).abs(), dim=-1)
    phase_consistency = torch.exp(-phase_err)

    p = signatures.abs() ** 2
    noise_floor = _percentile_linear(p, 20.0)
    snr = torch.where(noise_floor > 0, torch.mean(p, dim=-1)
                      / torch.clamp(noise_floor, min=1e-30), 0.0)
    snr_conf = torch.clamp(torch.log10(torch.clamp(snr, min=1e-12)) / 3.0,
                           0.0, 1.0)
    snr_conf = torch.where(noise_floor > 0, snr_conf, 0.0)

    conf = 0.4 * norm_corr + 0.3 * phase_consistency + 0.3 * snr_conf
    return torch.clamp(conf, 0.0, 1.0)


def mdl_model_order(eigenvalues: torch.Tensor, max_sources: int = 4):
    """MDL source count from DESCENDING eigenvalues [..., A] (geometric /
    arithmetic noise-eigenvalue ratio, rank-1 guard).

    Returns (num_sources int32, is_multipath bool, snr_ratio float32)."""
    A = eigenvalues.shape[-1]
    dev = eigenvalues.device
    ev = torch.clamp(eigenvalues, min=0.0)
    kmax = min(max_sources, A - 1)

    ks = torch.arange(1, kmax + 1, device=dev)                      # [H]
    col = torch.arange(A, device=dev)
    noise_mask = col[None, :] >= ks[:, None]                        # [H, A]
    L = (A - ks).to(torch.float32)                                  # [H]

    evb = ev[..., None, :].expand(*ev.shape[:-1], kmax, A)
    noise_sum = torch.sum(torch.where(noise_mask, evb, 0.0), dim=-1)
    arith = noise_sum / L
    log_ev = torch.log(torch.clamp(evb, min=1e-20))
    geo_log = torch.sum(torch.where(noise_mask, log_ev, 0.0), dim=-1) / L
    geo = torch.exp(geo_log)
    ratio = torch.where(arith > 0, geo / torch.clamp(arith, min=1e-30), 1.0)

    n_eff = float(A)  # single snapshot; sample count proxy
    ksf = ks.to(torch.float32)
    mdl = (-n_eff * L * torch.log(torch.clamp(ratio, min=1e-30))
           + 0.5 * ksf * (2 * A - ksf) * torch.log(L))
    mdl = torch.where(arith > 0, mdl, float("inf"))

    num_sources = torch.argmin(mdl, dim=-1).to(torch.int32) + 1
    rank1 = ev[..., 1] < 1e-6 * torch.clamp(ev[..., 0], min=1e-30)
    num_sources = torch.where(rank1, 1, num_sources).to(torch.int32)

    sig_mask = col < num_sources[..., None]
    sig_pow = torch.sum(torch.where(sig_mask, ev, 0.0), dim=-1)
    noi_pow = torch.sum(torch.where(~sig_mask, ev, 0.0), dim=-1)
    snr_ratio = torch.where(noi_pow > 0,
                            sig_pow / torch.clamp(noi_pow, min=1e-30),
                            float("inf"))
    return num_sources, num_sources > 1, snr_ratio
