"""Frozen copy of the parts of ``radar_slam_tpu_torch/signal/rds.py`` at
commit d8c8661 that the reference reads: the Doppler DFT matrix and the
baseband mix vector (imports renamed; the kernel paths, the raw-input
dechirp and the radial-velocity conversion left out).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.reference.core.config import RadarConfig
from portbench.reference.core.device import DEFAULT, resolve
from portbench.reference.ops.windows import get_window


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
    """Fast-time-window vector [S] (complex64) of baseband input."""
    w = get_window(window, S, device=device)
    if input_domain == "baseband":
        return w.to(torch.complex64)
    raise ValueError(f"Unknown input domain: {input_domain}")
