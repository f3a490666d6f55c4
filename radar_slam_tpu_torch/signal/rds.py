"""Range-Doppler constants: the folded DFT matrices, the mix vector and the
bin axes.

Counterpart of ``radar_slam_tpu/signal/rds.py`` for what the one-pass
front end uses.  The DFT constants are built in float32 with the
reference's operation order: the range phase reaches ~2.5e3 rad, where one
float32 ulp is ~2.4e-4 rad, so a float64 build would differ from the
reference constant by more than the front end's power tolerance.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import RadarConfig
from radar_slam_tpu_torch.ops.windows import get_window


def range_axis_m(cfg: RadarConfig, range_bins: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """Range value of each bin [m]: bin * c/(2B) * (fs T / S)."""
    n = range_bins or cfg.samples_per_chirp
    bin_hz = cfg.sampling_rate / n
    metres_per_hz = cfg.c / (2.0 * cfg.chirp_rate)
    return torch.arange(n, dtype=torch.float32,
                        device=device) * (bin_hz * metres_per_hz)


def doppler_axis_hz(cfg: RadarConfig, doppler_bins: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """Doppler frequency of each (fftshifted) bin [Hz], spanning +/- PRF/2."""
    n = doppler_bins or cfg.num_chirps
    return torch.fft.fftshift(torch.fft.fftfreq(
        n, d=cfg.pri, dtype=torch.float32, device=device))


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
                       device=None) -> torch.Tensor:
    """[C, C] complex64 matrix folding the Doppler chain: optional slow-time
    window on the rows, e^{-j} DFT, fftshift baked into the column order."""
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
                device=None) -> torch.Tensor:
    """Dechirp x fast-time-window vector [S] (complex64).  Only the
    baseband domain is ported: the raw domain needs the reference chirp of
    the cube-input path (ROADMAP, cube-input paths)."""
    if input_domain != "baseband":
        raise NotImplementedError(
            f"input_domain={input_domain!r}: only 'baseband' is ported "
            "(ROADMAP: cube-input and three-dispatch paths)")
    return get_window(window, S, device=device).to(torch.complex64)
