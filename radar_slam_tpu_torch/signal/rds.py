"""Range-Doppler spectrum of ADC cubes, its power map and the detected
cells' signatures; the folded DFT matrices, the mix vector and the bin axes.

Counterpart of ``radar_slam_tpu/signal/rds.py``.  The DFT constants are built in float32 with the
reference's operation order: the range phase reaches ~2.5e3 rad, where one
float32 ulp is ~2.4e-4 rad, so a float64 build would differ from the
reference constant by more than the front end's power tolerance.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import RadarConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.ops.windows import get_window
from radar_slam_tpu_torch.signal.synth import reference_chirp


def range_axis_m(cfg: RadarConfig, range_bins: Optional[int] = None,
                 device=DEFAULT) -> torch.Tensor:
    """Range value of each bin [m]: bin * c/(2B) * (fs T / S)."""
    n = range_bins or cfg.samples_per_chirp
    bin_hz = cfg.sampling_rate / n
    metres_per_hz = cfg.c / (2.0 * cfg.chirp_rate)
    return torch.arange(n, dtype=torch.float32,
                        device=resolve(device)) * (bin_hz * metres_per_hz)


def doppler_axis_hz(cfg: RadarConfig, doppler_bins: Optional[int] = None,
                    device=DEFAULT) -> torch.Tensor:
    """Doppler frequency of each (fftshifted) bin [Hz], spanning +/- PRF/2."""
    n = doppler_bins or cfg.num_chirps
    return torch.fft.fftshift(torch.fft.fftfreq(
        n, d=cfg.pri, dtype=torch.float32, device=resolve(device)))


def doppler_to_radial_velocity(doppler_hz: torch.Tensor,
                               cfg: RadarConfig) -> torch.Tensor:
    """vr = -f_d lambda / 2 (synthesis convention phase = -4 pi R / lambda)."""
    return -doppler_hz * float(np.float32(cfg.lambda_c)) / 2.0


def range_dft_matrix(S: int, mix: torch.Tensor,
                     dc_removal: bool) -> torch.Tensor:
    """[S, S] complex64 matrix folding the range chain into one matmul:
    diag(mix) @ (I - J/S) @ W, with W[s, r] = e^{+2j pi s r / S}."""
    s = torch.arange(S, dtype=torch.float32, device=mix.device)
    phase = (2.0 * math.pi / S) * torch.outer(s, s)
    w_rng = torch.polar(torch.ones_like(phase), phase)
    if dc_removal:
        w_rng = w_rng - torch.mean(w_rng, dim=0, keepdim=True)
    return mix[:, None] * w_rng


def doppler_dft_matrix(C: int, doppler_window: Optional[str],
                       device=DEFAULT) -> torch.Tensor:
    """[C, C] complex64 matrix folding the Doppler chain: optional slow-time
    window on the rows, e^{-j} DFT, fftshift baked into the column order."""
    device = resolve(device)
    c = torch.arange(C, dtype=torch.float32, device=device)
    k_shifted = torch.roll(torch.arange(C, dtype=torch.float32,
                                        device=device), C // 2)
    phase = -((2.0 * math.pi / C) * torch.outer(c, k_shifted))
    w_dop = torch.polar(torch.ones_like(phase), phase)
    if doppler_window is not None:
        wd = get_window(doppler_window, C, device=device)
        w_dop = wd[:, None] * w_dop
    return w_dop


def _mix_vector(cfg: RadarConfig, window: str, input_domain: str, S: int,
                device=DEFAULT) -> torch.Tensor:
    """Dechirp x fast-time-window vector [S] (complex64): the window, times
    conj(reference chirp) for raw input."""
    w = get_window(window, S, device=device)
    if input_domain == "raw":
        return torch.conj(reference_chirp(cfg, device)) * w
    if input_domain == "baseband":
        return w.to(torch.complex64)
    raise ValueError(f"Unknown input domain: {input_domain}")


def _complex_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., N] @ w [N, M] as four real float32 products."""
    xr, xi = x.real, x.imag
    wr, wi = w.real, w.imag
    return torch.complex(xr @ wr - xi @ wi, xr @ wi + xi @ wr)


def _rds_matmul(signals: torch.Tensor, mix: torch.Tensor, dc_removal: bool,
                doppler_window: Optional[str]) -> torch.Tensor:
    """RDS [..., A, S, C] as two DFT products: the range chain (mix, DC
    projector, e^{+j} DFT) as one [S, S] matrix on fast time, the Doppler
    chain (window, e^{-j} DFT, fftshift) as one [C, C] matrix on slow
    time."""
    S = signals.shape[-1]
    C = signals.shape[-2]
    w_rng = range_dft_matrix(S, mix, dc_removal)
    w_dop = doppler_dft_matrix(C, doppler_window, device=signals.device)
    rng = _complex_matmul(signals, w_rng)                  # [..., A, C, S]
    return _complex_matmul(rng.transpose(-1, -2), w_dop)


def _subset(signals: torch.Tensor, chirp_subset) -> torch.Tensor:
    """The chirps [lo, hi) of cubes [..., C, S], copied: the kernels'
    wrappers take contiguous cubes, and the slice is a strided view."""
    if chirp_subset is None:
        return signals
    return signals[..., chirp_subset[0]:chirp_subset[1], :].contiguous()


_PRECISIONS = ("default", "high", "highest")


def _check_precision(*names: str) -> None:
    """The port's products run in float32 at every precision name (the
    reference's bf16 / bf16x3 MXU passes have no counterpart); an unknown
    name still raises, as in the reference."""
    for name in names:
        if name not in _PRECISIONS:
            raise ValueError(f"Unknown precision: {name}")


def rds_power(signals: torch.Tensor, cfg: RadarConfig, window: str = "hann",
              dc_removal: bool = True, input_domain: str = "baseband",
              chirp_subset: Optional[Tuple[int, int]] = None,
              doppler_window: Optional[str] = None, mode: str = "auto",
              dft_precision: str = "default",
              doppler_precision: str = "highest",
              doppler_layout: str = "loop") -> torch.Tensor:
    """Non-coherent power map ``mean_a |rds|^2`` [..., R, D] (float32)
    without building the complex RDS cube.

    ``mode`` "pallas" runs the fused power kernel (``ops/power.py``,
    CUDA on a CUDA tensor, its plain version on a CPU tensor); "xla" the
    FFT path plus power; "auto" the kernel on a CUDA tensor and the FFT
    path elsewhere, as the reference picks its kernel on a TPU only.  The
    precision names are accepted for config parity; the port computes in
    float32 at each.  ``doppler_layout`` is a TPU tiling choice with one
    answer here."""
    _check_precision(dft_precision, doppler_precision)
    if doppler_layout not in ("loop", "wide"):
        raise ValueError(f"Unknown doppler_layout: {doppler_layout}")
    signals = _subset(signals, chirp_subset)
    if mode == "auto":
        mode = "pallas" if signals.device.type == "cuda" else "xla"
    if mode == "pallas":
        from radar_slam_tpu_torch.ops.power import rds_power_fused
        mix = _mix_vector(cfg, window, input_domain, signals.shape[-1],
                          device=signals.device)
        return rds_power_fused(signals, mix, dc_removal, doppler_window)
    if mode != "xla":
        raise ValueError(f"Unknown rds_power mode: {mode}")
    rds = range_doppler_spectrum(signals, cfg, window=window,
                                 dc_removal=dc_removal,
                                 input_domain=input_domain,
                                 doppler_window=doppler_window)
    return torch.mean(rds.abs() ** 2, dim=-3)


def signature_columns(S: int, C: int, range_bin: torch.Tensor,
                      doppler_bin: torch.Tensor, mix: torch.Tensor,
                      dc_removal: bool, doppler_window: Optional[str]):
    """The detected cells' DFT columns: range [F, S, K] (column r of
    ``range_dft_matrix``) and Doppler [F, C, K] (column d of
    ``doppler_dft_matrix``), complex64."""
    dev = mix.device
    # Column r of range_dft_matrix: mix * (e^{+2j pi s r / S} - [r == 0])
    # (the DC projector changes only the r = 0 column).
    s = torch.arange(S, dtype=torch.float32, device=dev)
    rb = range_bin.to(torch.float32)
    phase = (2.0 * math.pi / S) * (s[None, :, None] * rb[:, None, :])
    w_rng = torch.polar(torch.ones_like(phase), phase)            # [F, S, K]
    if dc_removal:
        w_rng = w_rng - (range_bin[:, None, :] == 0).to(torch.complex64)
    w_rng = mix[None, :, None] * w_rng
    return w_rng, doppler_columns(C, doppler_bin, doppler_window, dev)


def doppler_columns(C: int, doppler_bin: torch.Tensor,
                    doppler_window: Optional[str], device) -> torch.Tensor:
    """Columns [F, C, K] of ``doppler_dft_matrix`` at the Doppler bins
    [F, K]: window * e^{-2j pi c f(d) / C}, with the fftshift column order
    f(d) = (d - C//2) mod C."""
    c = torch.arange(C, dtype=torch.float32, device=device)
    f = torch.remainder(doppler_bin.to(device=device, dtype=torch.int64)
                        - C // 2, C).to(torch.float32)
    phase = -((2.0 * math.pi / C) * (c[None, :, None] * f[:, None, :]))
    w_dop = torch.polar(torch.ones_like(phase), phase)            # [F, C, K]
    if doppler_window is not None:
        w_dop = get_window(doppler_window, C, device=device)[:, None] * w_dop
    return w_dop


def unit_power(sig: torch.Tensor) -> torch.Tensor:
    """Signatures [..., A] scaled to unit power (zero ones kept)."""
    power = torch.sum(sig.abs() ** 2, dim=-1, keepdim=True)
    return torch.where(power > 0,
                       sig / torch.sqrt(torch.clamp(power, min=1e-30)), sig)


def signatures_from_columns(x: torch.Tensor, w_rng: torch.Tensor,
                            w_dop: torch.Tensor, A: int) -> torch.Tensor:
    """Unit-power signatures [F, K, A] of cubes x [F, A*C, S] (row a*C + c)
    against the columns of :func:`signature_columns`."""
    F, AC, S = x.shape
    g = torch.matmul(x, w_rng)                                    # [F, AC, K]
    sig = torch.einsum("fack,fck->fka", g.reshape(F, A, AC // A, -1), w_dop)
    return unit_power(sig)


def detection_signatures(signals: torch.Tensor, range_bin: torch.Tensor,
                         doppler_bin: torch.Tensor, cfg: RadarConfig,
                         window: str = "hann", dc_removal: bool = True,
                         input_domain: str = "baseband",
                         chirp_subset: Optional[Tuple[int, int]] = None,
                         doppler_window: Optional[str] = None
                         ) -> torch.Tensor:
    """Unit-power spatial signatures [F, K, A] of K detected cells per
    frame, evaluated from the cubes [F, A, C, S] as only the K needed DFT
    coefficients (float32).  ``range_bin`` / ``doppler_bin`` are [F, K].
    On a CUDA tensor the range columns are those of the exact DFT that K7
    runs (``ops/range_dft.py:range_columns_exact``), so the cube route's
    map and signatures are one transform; on the CPU the reference's."""
    signals = _subset(signals, chirp_subset)
    F, A, C, S = signals.shape
    mix = _mix_vector(cfg, window, input_domain, S, device=signals.device)
    w_rng, w_dop = signature_columns(S, C, range_bin, doppler_bin, mix,
                                     dc_removal, doppler_window)
    if signals.device.type == "cuda":
        from radar_slam_tpu_torch.ops.range_dft import range_columns_exact
        w_rng = range_columns_exact(S, range_bin, mix, dc_removal)
    return signatures_from_columns(signals.reshape(F, A * C, S), w_rng,
                                   w_dop, A)


def range_doppler_spectrum(signals: torch.Tensor, cfg: RadarConfig,
                           window: str = "hann", dc_removal: bool = True,
                           input_domain: str = "baseband",
                           chirp_subset: Optional[Tuple[int, int]] = None,
                           doppler_window: Optional[str] = None,
                           use_pallas: bool = False, fft_mode: str = "fft",
                           dft_precision: str = "highest") -> torch.Tensor:
    """The complex RDS [..., A, R, D] of cubes [..., A, C, S]: Doppler axis
    fftshifted, range axis unshifted (bin r -> r c / (2B)).

    ``fft_mode`` "fft" runs torch's FFTs (the range transform as S * ifft,
    the e^{+j} kernel), with the dechirp / window / DC stage through the
    dechirp kernel (``ops/dechirp.py``) when ``use_pallas``; "matmul" the
    two DFT products in plain torch; "pallas" the fused RDS kernel
    (``ops/rds.py``).  A kernel runs in CUDA on a CUDA tensor and as its
    plain version on a CPU tensor."""
    _check_precision(dft_precision)
    signals = _subset(signals, chirp_subset)
    S = signals.shape[-1]
    mix = _mix_vector(cfg, window, input_domain, S, device=signals.device)
    if fft_mode == "matmul":
        return _rds_matmul(signals, mix, dc_removal, doppler_window)
    if fft_mode == "pallas":
        from radar_slam_tpu_torch.ops.rds import rds_fused
        return rds_fused(signals, mix, dc_removal, doppler_window)
    if fft_mode != "fft":
        raise ValueError(f"Unknown fft_mode: {fft_mode}")

    if use_pallas:
        from radar_slam_tpu_torch.ops.dechirp import dechirp_window_dc
        x = dechirp_window_dc(signals, mix, dc_removal)
    else:
        x = signals * mix
        if dc_removal:
            x = x - torch.mean(x, dim=-1, keepdim=True)
    C = x.shape[-2]
    wd = (get_window(doppler_window, C, device=x.device)
          if doppler_window is not None
          else torch.ones(C, dtype=torch.float32, device=x.device))
    if C % 2 == 0:
        # (-1)^c on slow time shifts the spectrum by C/2 bins: the fftshift.
        sign = 1.0 - 2.0 * (torch.arange(C, device=x.device) % 2)
        wd = wd * sign
    x = x * wd[:, None].to(torch.complex64)
    rng = torch.fft.ifft(x, dim=-1) * S                     # [..., A, C, R]
    rds = torch.fft.fft(rng.transpose(-1, -2), dim=-1)      # [..., A, R, D]
    if C % 2 != 0:
        rds = torch.fft.fftshift(rds, dim=-1)
    return rds.to(torch.complex64)
