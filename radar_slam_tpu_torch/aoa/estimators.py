"""Batched beamforming angle-of-arrival estimation.

Counterpart of ``radar_slam_tpu/aoa/estimators.py`` for the production
method (beamforming over a ULA): the spectrum of every detection is one
complex matmul |S A^H|^2 against the grid steering matrix, refined by a
parabola through the peak and its neighbours.  Leading axes (frames,
detections) broadcast.  MUSIC, ESPRIT and URA arrays are not ported yet.
"""

from __future__ import annotations

import torch

from radar_slam_tpu_torch.core.config import AoAConfig, RadarConfig
from radar_slam_tpu_torch.core.geometry import steering_matrix


def azimuth_grid_deg(aoa: AoAConfig, device=None) -> torch.Tensor:
    """Search grid in degrees [G], evaluated in float64 and rounded once
    (the reference's float32 ``jnp.linspace`` lands within 2 ulps)."""
    return torch.linspace(aoa.search_min_deg, aoa.search_max_deg,
                          aoa.num_grid_points, dtype=torch.float64,
                          device=device).to(torch.float32)


def _require_ula(cfg: RadarConfig):
    if cfg.num_antennas_el > 1:
        raise NotImplementedError(
            "num_antennas_el > 1 (URA, joint az-el search) is not ported "
            "yet (ROADMAP: remaining estimation)")


def grid_steering_matrix(cfg: RadarConfig, aoa: AoAConfig,
                         device=None) -> torch.Tensor:
    """Steering matrix over the azimuth grid: [G, A] complex64 (ULA)."""
    _require_ula(cfg)
    grid_rad = torch.deg2rad(azimuth_grid_deg(aoa, device))
    return steering_matrix(grid_rad, cfg.num_antennas, cfg.spacing,
                           cfg.lambda_c)


def _refine_peak(spectrum: torch.Tensor,
                 grid_deg: torch.Tensor) -> torch.Tensor:
    """Argmax (first maximum, as ``jnp.argmax``) + parabolic sub-bin
    interpolation over the grid, interior peaks only."""
    g = spectrum.shape[-1]
    idx = torch.argmax(spectrum, dim=-1, keepdim=True)
    ym = torch.gather(spectrum, -1, torch.clamp(idx - 1, 0, g - 1))[..., 0]
    y0 = torch.gather(spectrum, -1, idx)[..., 0]
    yp = torch.gather(spectrum, -1, torch.clamp(idx + 1, 0, g - 1))[..., 0]
    idx = idx[..., 0]
    denom = ym - 2.0 * y0 + yp
    big = denom.abs() > 1e-12
    delta = torch.where(big, 0.5 * (ym - yp)
                        / torch.where(big, denom, 1.0), 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    delta = torch.where((idx > 0) & (idx < g - 1), delta, 0.0)
    step = grid_deg[1] - grid_deg[0]
    return grid_deg[idx] + delta * step


def beamforming_spectrum(signatures: torch.Tensor,
                         steering: torch.Tensor) -> torch.Tensor:
    """Conventional beamforming power spectra [..., K, G] = |S A^H|^2."""
    resp = signatures @ steering.conj().transpose(0, 1)
    return resp.real ** 2 + resp.imag ** 2


def estimate_beamforming(signatures: torch.Tensor, cfg: RadarConfig,
                         aoa: AoAConfig):
    """Batched beamforming AoA with sub-grid refinement:
    (angles_deg [..., K], spectra [..., K, G])."""
    grid = azimuth_grid_deg(aoa, signatures.device)
    spec = beamforming_spectrum(
        signatures, grid_steering_matrix(cfg, aoa, signatures.device))
    return _refine_peak(spec, grid), spec


def rank1_eigenvalues(signatures: torch.Tensor) -> torch.Tensor:
    """Analytic descending eigenvalues [..., K, A] of the rank-1
    single-snapshot covariance s s^H: (||s||^2, 0, ..., 0)."""
    p = torch.sum(signatures.abs() ** 2, dim=-1)
    out = torch.zeros(signatures.shape, dtype=p.dtype,
                      device=signatures.device)
    out[..., 0] = p
    return out


def estimate_angles(signatures: torch.Tensor, cfg: RadarConfig,
                    aoa: AoAConfig, method: str = "beamforming",
                    num_sources=1):
    """Dispatch over estimation methods: (angles_deg, spectra)."""
    if method == "beamforming":
        return estimate_beamforming(signatures, cfg, aoa)
    if method in ("music", "esprit"):
        raise NotImplementedError(
            f"AoA method {method!r} is not ported yet (ROADMAP: modules to "
            "port, MUSIC / ESPRIT)")
    raise ValueError(f"Unknown method: {method}")


def estimate_angles_2d(signatures: torch.Tensor, cfg: RadarConfig,
                       aoa: AoAConfig, method: str = "beamforming",
                       num_sources=1):
    """(az_deg, el_deg, spectra); elevation is identically zero for a
    ULA."""
    _require_ula(cfg)
    az, spec = estimate_angles(signatures, cfg, aoa, method, num_sources)
    return az, torch.zeros_like(az), spec
