"""Batched angle-of-arrival estimation: beamforming, MUSIC, ESPRIT, on a
ULA (azimuth) or a URA (joint azimuth and elevation).

Counterpart of ``radar_slam_tpu/aoa/estimators.py``.  Leading axes
(frames, detections) broadcast.

- beamforming: the spectrum of every detection is one complex matmul
  |S A^H|^2 against the grid steering matrix, refined by a parabola
  through the peak and its neighbours;
- MUSIC: the null spectrum a^H P_n a from the closed-form rank-<=2 signal
  subspace of the single-snapshot covariance (forward-backward averaged
  with ``music_fb``), as the residual norm ||a - sum (e_j^H a) e_j||^2,
  refined on the negated null spectrum;
- ESPRIT: the phase slope between shifted subarrays, lag 1 or the
  |r_m|-weighted fit over every lag (``esprit_weighted``); on a URA along
  each axis of the array.

On a URA (``num_antennas_el > 1``) the grid is the el-major joint grid
[G_el * G_az], and the peak is refined along each axis
(:func:`_refine_peak_2d`).  Its spectra are G_el times a ULA's, so they
are computed over chunks of signatures.

:func:`locate_angles_2d` gives the angles alone: on the card a
beamforming search then finds each peak and its neighbour taps in one
kernel (``ops/beam.py``) and keeps no spectrum.
"""

from __future__ import annotations

import functools
import math

import torch

from radar_slam_tpu_torch.core.config import AoAConfig, RadarConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.geometry import (steering_matrix,
                                                ura_steering_vector)
from radar_slam_tpu_torch.ops import beam


def azimuth_grid_deg(aoa: AoAConfig, device=DEFAULT) -> torch.Tensor:
    """Search grid in degrees [G], evaluated in float64 and rounded once
    (the reference's float32 ``jnp.linspace`` lands within 2 ulps)."""
    return torch.linspace(aoa.search_min_deg, aoa.search_max_deg,
                          aoa.num_grid_points, dtype=torch.float64,
                          device=resolve(device)).to(torch.float32)


def elevation_grid_deg(aoa: AoAConfig, device=DEFAULT) -> torch.Tensor:
    """Elevation search grid in degrees [G_el] (URA), as
    :func:`azimuth_grid_deg`."""
    return torch.linspace(aoa.el_min_deg, aoa.el_max_deg,
                          aoa.num_el_grid_points, dtype=torch.float64,
                          device=resolve(device)).to(torch.float32)


def grid_steering_matrix(cfg: RadarConfig, aoa: AoAConfig,
                         device=DEFAULT) -> torch.Tensor:
    """Steering matrix over the search grid: ULA [G_az, A] over the
    azimuth grid; URA [G_el * G_az, A] over the el-major joint grid
    (azimuth fastest).  complex64."""
    az = torch.deg2rad(azimuth_grid_deg(aoa, device))
    if cfg.num_antennas_el > 1:
        el = torch.deg2rad(elevation_grid_deg(aoa, device))
        return ura_steering_vector(
            az.repeat(aoa.num_el_grid_points),
            el.repeat_interleave(aoa.num_grid_points), cfg.num_antennas,
            cfg.num_antennas_el, cfg.spacing, cfg.spacing_el, cfg.lambda_c)
    return steering_matrix(az, cfg.num_antennas, cfg.spacing, cfg.lambda_c)


def _parabola(ym, y0, yp, interior):
    """Sub-bin offset of the parabola through three samples, in
    [-0.5, 0.5]; 0 on a flat triple and where not ``interior``."""
    denom = ym - 2.0 * y0 + yp
    big = denom.abs() > 1e-12
    delta = torch.where(big, 0.5 * (ym - yp)
                        / torch.where(big, denom, 1.0), 0.0)
    return torch.where(interior, torch.clamp(delta, -0.5, 0.5), 0.0)


def _angles_from_taps(idx: torch.Tensor, taps: torch.Tensor,
                      az_grid: torch.Tensor, el_grid=None):
    """(az_deg [...], el_deg [...]) from peak indices [...] of the
    flattened el-major grid and their taps [..., 5] (``ops/beam.py``'s
    ``TAP_STEPS``): a parabola along each axis through the peak's
    neighbours on that axis, interior peaks only; el_deg is zero where
    ``el_grid`` is None (a ULA)."""
    Gaz = az_grid.shape[0]
    ie, ia = idx // Gaz, idx % Gaz
    y0 = taps[..., 0]
    da = _parabola(taps[..., 1], y0, taps[..., 2], (ia > 0) & (ia < Gaz - 1))
    az_step = az_grid[1] - az_grid[0] if Gaz > 1 else 0.0
    az = az_grid[ia] + da * az_step
    if el_grid is None:
        return az, torch.zeros_like(az)
    Gel = el_grid.shape[0]
    de = _parabola(taps[..., 3], y0, taps[..., 4], (ie > 0) & (ie < Gel - 1))
    el_step = el_grid[1] - el_grid[0] if Gel > 1 else 0.0
    return az, el_grid[ie] + de * el_step


def _refine_peak(spectrum: torch.Tensor,
                 grid_deg: torch.Tensor) -> torch.Tensor:
    """Argmax (first maximum, as ``jnp.argmax``) + parabolic sub-bin
    interpolation over the grid, interior peaks only."""
    idx, taps = beam.spectrum_peak_taps(spectrum, 1, spectrum.shape[-1])
    return _angles_from_taps(idx, taps, grid_deg)[0]


def _refine_peak_2d(spec: torch.Tensor, az_grid: torch.Tensor,
                    el_grid: torch.Tensor):
    """Joint argmax (first maximum of the flattened grid) of spectra
    [..., G_el, G_az] and a parabola along each axis through the peak's
    neighbours on that axis.  Returns (az_deg [...], el_deg [...])."""
    Gel, Gaz = spec.shape[-2:]
    idx, taps = beam.spectrum_peak_taps(
        spec.reshape(*spec.shape[:-2], Gel * Gaz), Gel, Gaz)
    return _angles_from_taps(idx, taps, az_grid, el_grid)


# Complex elements per chunk of a spectrum's intermediate.  MUSIC's
# residual [n, G, A]: ~0.2 GB of complex64, 32k signatures at the ULA
# bench's G = 91, A = 8.  Beamforming's response [n, G]: 1 GiB, so a ULA
# at G = 91 stays one product up to 1.47M signatures (8192 frames of
# K = 64 are 524k) and the URA's 11,041-point joint grid takes 12k.
_MUSIC_CHUNK_ELEMS = (8 * 91) << 15
_BEAMFORMING_CHUNK_ELEMS = 1 << 27


def _chunk(elems: int, per_signature: int) -> int:
    """Signatures per chunk of an intermediate of ``per_signature``
    elements per signature, within ``elems``."""
    return max(1, elems // per_signature)


def _count_product(rows: int, G: int) -> None:
    beamforming_spectrum.chunks += 1
    beamforming_spectrum.products += rows * G


def beamforming_spectrum(signatures: torch.Tensor,
                         steering: torch.Tensor) -> torch.Tensor:
    """Conventional beamforming power spectra [..., K, G] = |S A^H|^2, one
    complex product per chunk of signatures.  ``.calls`` counts the calls,
    ``.chunks`` the products launched and ``.products`` their signature x
    grid-point pairs, on the host at each launch (a replayed CUDA graph
    adds none); a caller resets them by assigning 0."""
    a_h = steering.conj().transpose(0, 1)
    G = steering.shape[0]
    s = signatures.reshape(-1, signatures.shape[-1])
    n = _chunk(_BEAMFORMING_CHUNK_ELEMS, G)
    beamforming_spectrum.calls += 1
    if s.shape[0] <= n:
        _count_product(s.shape[0], G)
        resp = s @ a_h
        spec = resp.real ** 2 + resp.imag ** 2
    else:
        spec = torch.empty(s.shape[0], G, dtype=s.real.dtype,
                           device=s.device)
        for i in range(0, s.shape[0], n):
            _count_product(min(n, s.shape[0] - i), G)
            resp = s[i:i + n] @ a_h
            spec[i:i + n] = resp.real ** 2 + resp.imag ** 2
    return spec.reshape(*signatures.shape[:-1], G)


beamforming_spectrum.calls = 0
beamforming_spectrum.chunks = 0
beamforming_spectrum.products = 0


def _refine_grid(spec: torch.Tensor, cfg: RadarConfig, aoa: AoAConfig):
    """(az_deg, el_deg) at the peak of spectra [..., G] over the search
    grid: the ULA's azimuth parabola (el_deg zero), or the URA's joint
    refinement."""
    az_grid = azimuth_grid_deg(aoa, spec.device)
    if cfg.num_antennas_el > 1:
        return _refine_peak_2d(
            spec.reshape(*spec.shape[:-1], aoa.num_el_grid_points,
                         aoa.num_grid_points), az_grid,
            elevation_grid_deg(aoa, spec.device))
    az = _refine_peak(spec, az_grid)
    return az, torch.zeros_like(az)


def _grid_search(signatures: torch.Tensor, cfg: RadarConfig,
                 aoa: AoAConfig, method: str, num_sources=1,
                 forward_backward: bool = False, refine: bool = True):
    """The grid search of beamforming or MUSIC: (az_deg, el_deg, spectra),
    el_deg zero on a ULA.  The peak is refined on the spectrum
    (beamforming) or on the negated null spectrum (MUSIC); unrefined,
    which only a ULA's MUSIC takes, the argmax of the pseudo-spectrum."""
    steering = grid_steering_matrix(cfg, aoa, signatures.device)
    if method == "beamforming":
        spec = beamforming_spectrum(signatures, steering)
        peak = spec
    elif method == "music":
        denom = music_denominator(signatures, steering, num_sources,
                                  forward_backward)
        spec, peak = _pseudo_spectrum(denom), -denom
    else:
        raise ValueError(f"Unknown method: {method}")
    if not refine and cfg.num_antennas_el == 1:
        az = azimuth_grid_deg(aoa, spec.device)[torch.argmax(spec, dim=-1)]
        return az, torch.zeros_like(az), spec
    return (*_refine_grid(peak, cfg, aoa), spec)


def estimate_beamforming(signatures: torch.Tensor, cfg: RadarConfig,
                         aoa: AoAConfig):
    """Batched beamforming AoA with sub-grid refinement:
    (angles_deg [..., K], spectra [..., K, G]); on a URA the azimuth of
    the joint search."""
    az, _, spec = _grid_search(signatures, cfg, aoa, "beamforming")
    return az, spec


def rank1_eigenvalues(signatures: torch.Tensor) -> torch.Tensor:
    """Analytic descending eigenvalues [..., K, A] of the rank-1
    single-snapshot covariance s s^H: (||s||^2, 0, ..., 0)."""
    p = torch.sum(signatures.abs() ** 2, dim=-1)
    out = torch.zeros(signatures.shape, dtype=p.dtype,
                      device=signatures.device)
    out[..., 0] = p
    return out


# ---- subspace methods -------------------------------------------------------

def signature_covariances(signatures: torch.Tensor,
                          forward_backward: bool = False,
                          diagonal_load: float = 0.0) -> torch.Tensor:
    """Single-snapshot covariances [..., A, A] = s s^H, averaged with
    J conj(R) J (``forward_backward``) and loaded with eps I
    (``diagonal_load``)."""
    R = signatures[..., :, None] * signatures[..., None, :].conj()
    if forward_backward:
        # J X J with the exchange matrix J reverses both axes of X.
        R = 0.5 * (R + torch.flip(R.conj(), (-2, -1)))
    if diagonal_load:
        R = R + diagonal_load * torch.eye(R.shape[-1], dtype=R.dtype,
                                          device=R.device)
    return R


def eigendecompose(R: torch.Tensor):
    """Batched Hermitian eigendecomposition with DESCENDING eigenvalues:
    (eigenvalues [..., A] real, eigenvectors [..., A, A], column i the
    i-th).  ``torch.linalg.eigh`` returns them ascending."""
    vals, vecs = torch.linalg.eigh(R)
    return torch.flip(vals, (-1,)), torch.flip(vecs, (-1,))


def _rank2_signal_eigvecs(signatures: torch.Tensor, forward_backward: bool):
    """Closed-form top-2 eigenvectors of the single-snapshot covariance.

    Without forward-backward averaging the covariance is the rank-1 s s^H
    (top eigenvector s/|s|); with it, (s s^H + t t^H)/2 with t = J conj(s),
    whose nonzero eigenvectors lie in span{s, t} and come from a 2x2
    Hermitian eigenproblem.  Returns (E [..., 2, A] orthonormal,
    descending; rank [...] int32 in {0, 1, 2}); where the pair is colinear
    or s = 0 the second row is zero and the rank says so."""
    eps = 1e-20
    ns = torch.sqrt(torch.sum(signatures.abs() ** 2, dim=-1,
                              keepdim=True))                     # [..., 1]
    u1 = signatures / torch.clamp(ns, min=eps)
    if not forward_backward:
        E = torch.stack([u1, torch.zeros_like(u1)], dim=-2)
        return E, (ns[..., 0] > 0).to(torch.int32)
    t = torch.flip(signatures.conj(), (-1,))                     # J conj(s)
    c = torch.sum(u1.conj() * t, dim=-1, keepdim=True)           # u1^H t
    w = t - c * u1
    nw = torch.sqrt(torch.sum(w.abs() ** 2, dim=-1, keepdim=True))
    rank2 = nw[..., 0] > 1e-6 * torch.clamp(ns[..., 0], min=eps)
    u2 = torch.where(rank2[..., None], w / torch.clamp(nw, min=eps), 0.0)
    # R_fb in the {u1, u2} basis: 0.5 ([[|s|^2, 0], [0, 0]] + tau tau^H),
    # tau = (c, |w|).
    a11 = 0.5 * (ns[..., 0] ** 2 + c[..., 0].abs() ** 2)
    a12 = 0.5 * (c[..., 0] * nw[..., 0])                         # complex
    a22 = 0.5 * nw[..., 0] ** 2
    mean = 0.5 * (a11 + a22)
    disc = torch.sqrt(torch.clamp((0.5 * (a11 - a22)) ** 2 + a12.abs() ** 2,
                                  min=0.0))
    lam1 = mean + disc
    # The lam1 eigenvector of [[a11, a12], [conj(a12), a22]]: the
    # (a12, lam1 - a11) form, or (lam1 - a22, conj(a12)) where that pair
    # degenerates (a12 ~ 0 and lam1 ~ a11: e1 = u1).
    v1a = torch.stack([a12, (lam1 - a11).to(a12.dtype)], dim=-1)
    v1b = torch.stack([(lam1 - a22).to(a12.dtype), a12.conj()], dim=-1)
    use_b = (v1b[..., 0].abs() + v1b[..., 1].abs()
             > v1a[..., 0].abs() + v1a[..., 1].abs())
    v1 = torch.where(use_b[..., None], v1b, v1a)
    n1 = torch.sqrt(torch.sum(v1.abs() ** 2, dim=-1, keepdim=True))
    e0 = _unit_pair(v1.dtype, str(v1.device))
    v1 = torch.where(n1 > eps, v1 / torch.clamp(n1, min=eps), e0)
    # The in-span orthogonal complement is the lam2 eigenvector.
    v2 = torch.stack([-v1[..., 1].conj(), v1[..., 0].conj()], dim=-1)
    e1 = v1[..., :1] * u1 + v1[..., 1:] * u2
    e2 = v2[..., :1] * u1 + v2[..., 1:] * u2
    e1 = torch.where(rank2[..., None], e1, u1)
    e2 = torch.where(rank2[..., None], e2, 0.0)
    rank = (ns[..., 0] > 0).to(torch.int32) + rank2.to(torch.int32)
    return torch.stack([e1, e2], dim=-2), rank


@functools.lru_cache(maxsize=None)
def _unit_pair(dtype: torch.dtype, device: str) -> torch.Tensor:
    """(1, 0) [2] in ``dtype`` on ``device``, read-only, built once per
    pair: the MUSIC eigenvectors copy nothing from the host per call."""
    return torch.tensor([1.0, 0.0], dtype=dtype, device=device)


def music_denominator(signatures: torch.Tensor, steering: torch.Tensor,
                      num_sources=1,
                      forward_backward: bool = False) -> torch.Tensor:
    """MUSIC null spectra [..., K, G]: d(theta) = a^H P_n a with
    P_n = I - sum_{j < min(m, rank)} e_j e_j^H (the closed-form signal
    eigenvectors of :func:`_rank2_signal_eigvecs`).

    Evaluated as the RESIDUAL NORM ||a - sum_j (e_j^H a) e_j||^2, never as
    |a|^2 - sum_j |e_j^H a|^2: near the null both terms of the difference
    are ~A, so it loses ~1e-7 A absolutely -- all of the value at the bins
    the sub-grid refinement fits.  The residual is evaluated over chunks
    of signatures to bound its [n, G, A] intermediates
    (``_MUSIC_CHUNK_ELEMS``)."""
    lead = signatures.shape[:-1]
    A = signatures.shape[-1]
    m = torch.broadcast_to(torch.as_tensor(num_sources, dtype=torch.int32,
                                           device=signatures.device), lead)
    E, rank = _rank2_signal_eigvecs(signatures.reshape(-1, A),
                                    forward_backward)            # [n, 2, A]
    m = torch.minimum(m.reshape(-1), rank)
    sig_mask = torch.arange(2, device=m.device)[None, :] < m[:, None]
    n = _chunk(_MUSIC_CHUNK_ELEMS, steering.shape[0] * A)
    out = []
    for i in range(0, E.shape[0], n):
        e = E[i:i + n]
        # proj[n, j, g] = e_j^H a_g  (one [n*2, A] x [A, G] product).
        proj = e.conj() @ steering.transpose(0, 1)
        proj = torch.where(sig_mask[i:i + n, :, None], proj, 0.0)
        resid = steering[None] - proj.transpose(1, 2) @ e        # [n, G, A]
        out.append(torch.sum(resid.real ** 2 + resid.imag ** 2, dim=-1))
    return torch.cat(out).reshape(*lead, steering.shape[0])


def _pseudo_spectrum(denom: torch.Tensor) -> torch.Tensor:
    return torch.where(denom > 1e-12, 1.0 / torch.clamp(denom, min=1e-12),
                       0.0)


def music_spectrum(signatures: torch.Tensor, steering: torch.Tensor,
                   num_sources=1,
                   forward_backward: bool = False) -> torch.Tensor:
    """MUSIC pseudo-spectra [..., K, G] = 1 / (a^H P_n a), 0 where the
    null spectrum is at most 1e-12."""
    return _pseudo_spectrum(music_denominator(signatures, steering,
                                              num_sources, forward_backward))


def estimate_music(signatures: torch.Tensor, cfg: RadarConfig,
                   aoa: AoAConfig, num_sources=1, refine: bool = True,
                   forward_backward: bool = False):
    """Batched MUSIC AoA: (angles_deg [..., K], pseudo-spectra [..., K, G]).

    The sub-grid parabola is fitted to the NEGATED null spectrum, which is
    locally quadratic at the source, not to the pseudo-spectrum, a
    near-pole there; the unrefined path takes the argmax of the (clamped)
    pseudo-spectrum.  On a URA the azimuth of the joint search, always
    refined, as the reference's."""
    az, _, spec = _grid_search(signatures, cfg, aoa, "music", num_sources,
                               forward_backward, refine)
    return az, spec


def _multilag_slope(signatures: torch.Tensor, max_lag: int,
                    sum_axes=(-1,)) -> torch.Tensor:
    """Phase slope of a single spatial tone from every lag m = 1..M:
    r_m = sum_i conj(s_i) s_{i+m} (products shift along the last axis,
    summed over ``sum_axes``), each lag's angle unwrapped onto the lag-1
    line (the nearest 2 pi branch of m phi_1, ties to even), then the
    |r_m|-weighted least-squares slope through the origin."""
    rs = [torch.sum(signatures[..., :-m].conj() * signatures[..., m:],
                    dim=sum_axes) for m in range(1, max_lag + 1)]
    phi1 = torch.angle(rs[0])
    num = torch.zeros_like(phi1)
    den = torch.zeros_like(phi1)
    two_pi = 2.0 * math.pi
    for m, r in enumerate(rs, start=1):
        phi = torch.angle(r)
        phi = phi + two_pi * torch.round((float(m) * phi1 - phi) / two_pi)
        w = r.abs()
        num = num + w * float(m) * phi
        den = den + w * float(m * m)
    return num / torch.clamp(den, min=1e-30)


def estimate_esprit(signatures: torch.Tensor, cfg: RadarConfig,
                    weighted: bool = True) -> torch.Tensor:
    """Batched ESPRIT azimuths [..., K] in degrees: the phase between the
    shifted subarrays, angle(s[:-1]^H s[1:]), or with ``weighted`` the
    multi-lag slope (:func:`_multilag_slope`), then
    az = arcsin(phi lambda / (2 pi d))."""
    if weighted:
        A = signatures.shape[-1]
        phi = _multilag_slope(signatures, max_lag=max(A - 1, 1))
    else:
        phi = torch.angle(torch.sum(signatures[..., :-1].conj()
                                    * signatures[..., 1:], dim=-1))
    arg = phi * cfg.lambda_c / (2.0 * math.pi * cfg.spacing)
    return torch.rad2deg(torch.asin(torch.clamp(arg, -1.0, 1.0)))


def estimate_esprit_ura(signatures: torch.Tensor, cfg: RadarConfig,
                        weighted: bool = True):
    """Batched URA ESPRIT: (az_deg [...], el_deg [...]) from signatures
    [..., A_el * A_az] (row-major [el, az]).  The shift invariance along
    the azimuth columns gives u_y = cos el sin az, along the elevation rows
    u_z = sin el; ``weighted`` takes the multi-lag slope along each axis
    (summed over the other), else lag 1."""
    s = signatures.reshape(*signatures.shape[:-1], cfg.num_antennas_el,
                           cfg.num_antennas)
    if weighted:
        phi_az = _multilag_slope(s, max(cfg.num_antennas - 1, 1),
                                 sum_axes=(-2, -1))
        phi_el = _multilag_slope(s.transpose(-1, -2),
                                 max(cfg.num_antennas_el - 1, 1),
                                 sum_axes=(-2, -1))
    else:
        phi_az = torch.angle(torch.sum(s[..., :-1].conj() * s[..., 1:],
                                       dim=(-2, -1)))
        phi_el = torch.angle(torch.sum(s[..., :-1, :].conj()
                                       * s[..., 1:, :], dim=(-2, -1)))
    u_y = phi_az * cfg.lambda_c / (2.0 * math.pi * cfg.spacing)
    u_z = phi_el * cfg.lambda_c / (2.0 * math.pi * cfg.spacing_el)
    el = torch.asin(torch.clamp(u_z, -1.0, 1.0))
    cos_el = torch.clamp(torch.cos(el), min=1e-3)
    az = torch.asin(torch.clamp(u_y / cos_el, -1.0, 1.0))
    return torch.rad2deg(az), torch.rad2deg(el)


def estimate_angles(signatures: torch.Tensor, cfg: RadarConfig,
                    aoa: AoAConfig, method: str = "beamforming",
                    num_sources=1):
    """Dispatch over estimation methods: (angles_deg, spectra); ESPRIT
    has no spectra (None).  MUSIC reads ``aoa.music_fb``, ESPRIT
    ``aoa.esprit_weighted``.  On a URA the azimuth of the joint
    estimate."""
    az, _, spec = estimate_angles_2d(signatures, cfg, aoa, method,
                                     num_sources)
    return az, spec


def estimate_angles_2d(signatures: torch.Tensor, cfg: RadarConfig,
                       aoa: AoAConfig, method: str = "beamforming",
                       num_sources=1):
    """Joint azimuth-elevation estimation: (az_deg, el_deg, spectra, None
    for ESPRIT).  On a ULA elevation is identically zero; on a URA the
    joint grid search (beamforming, or MUSIC refined on the negated null
    spectrum) or URA ESPRIT."""
    if method == "esprit":
        if cfg.num_antennas_el > 1:
            az, el = estimate_esprit_ura(signatures, cfg,
                                         weighted=aoa.esprit_weighted)
        else:
            az = estimate_esprit(signatures, cfg,
                                 weighted=aoa.esprit_weighted)
            el = torch.zeros_like(az)
        return az, el, None
    return _grid_search(signatures, cfg, aoa, method, num_sources,
                        forward_backward=aoa.music_fb)


def grid_route(signatures: torch.Tensor, cfg: RadarConfig,
               method: str) -> str:
    """How :func:`locate_angles_2d` searches: ``"fused"`` (a beamforming
    search on the card over an array the kernel holds, ``ops/beam.py:fits``:
    its kernel, no spectrum) or ``"spectrum"`` (:func:`estimate_angles_2d`)."""
    if (method == "beamforming" and signatures.device.type == "cuda"
            and beam.fits(cfg.num_antennas, cfg.num_antennas_el)):
        return "fused"
    return "spectrum"


@functools.lru_cache(maxsize=None)
def _fused_search_constants(cfg: RadarConfig, aoa: AoAConfig, device: str):
    """The fused search's grid constants (``ops/beam.py:grid_constants``)
    and the grids in degrees on ``device``, built once per (radar, AoA
    configuration, device) and shared read-only, so that a call builds
    none (the streaming step's CUDA graph reads them).  The elevation
    grid is None on a ULA."""
    az = azimuth_grid_deg(aoa, device)
    el = (elevation_grid_deg(aoa, device) if cfg.num_antennas_el > 1
          else None)
    consts = beam.grid_constants(
        grid_steering_matrix(cfg, aoa, device), torch.deg2rad(az),
        torch.zeros(1) if el is None else torch.deg2rad(el),
        cfg.num_antennas, cfg.num_antennas_el, cfg.spacing, cfg.spacing_el,
        cfg.lambda_c)
    return consts, az, el


def locate_angles_2d(signatures: torch.Tensor, cfg: RadarConfig,
                     aoa: AoAConfig, method: str = "beamforming",
                     num_sources=1):
    """(az_deg [...], el_deg [...]) of signatures [..., A]: the first two
    outputs of :func:`estimate_angles_2d`, without its spectra.  A
    beamforming search on a CUDA tensor (:func:`grid_route` ``"fused"``)
    takes each peak and its neighbour taps from ``ops/beam.py``'s kernel
    and refines them as the spectrum route does; MUSIC, ESPRIT, CPU
    tensors and arrays the kernel does not hold take
    :func:`estimate_angles_2d`."""
    if grid_route(signatures, cfg, method) == "spectrum":
        az, el, _ = estimate_angles_2d(signatures, cfg, aoa, method,
                                       num_sources)
        return az, el
    consts, az_grid, el_grid = _fused_search_constants(
        cfg, aoa, str(signatures.device))
    lead = signatures.shape[:-1]
    idx, taps = beam.peak_taps(
        signatures.reshape(-1, signatures.shape[-1]).contiguous(), consts)
    az, el = _angles_from_taps(idx, taps, az_grid, el_grid)
    return az.reshape(lead), el.reshape(lead)
