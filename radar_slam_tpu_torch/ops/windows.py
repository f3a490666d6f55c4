"""FFT window functions and their spectral taps.

Counterpart of ``radar_slam_tpu/ops/windows.py``: symmetric windows by
default (scipy parity), ``periodic=True`` for the DFT-proper variant, and
the circular-convolution taps of the periodic window that shape the
range-frequency noise of the one-pass front end.
"""

from __future__ import annotations

import math

import torch

from radar_slam_tpu_torch.core.device import DEFAULT, resolve


def _cosine_window(n: int, coeffs, periodic: bool, device) -> torch.Tensor:
    denom = n if periodic else max(n - 1, 1)
    x = 2.0 * math.pi * torch.arange(n, dtype=torch.float32,
                                     device=device) / denom
    w = torch.zeros(n, dtype=torch.float32, device=device)
    for k, a in enumerate(coeffs):
        w = w + a * torch.cos(k * x) * (-1.0) ** k
    return w


_COEFFS = {"hann": (0.5, 0.5), "hamming": (0.54, 0.46),
           "blackman": (0.42, 0.5, 0.08)}


def get_window(name, n: int, periodic: bool = False,
               device=DEFAULT) -> torch.Tensor:
    """Named window [n] float32 ("rect"/None = ones) on ``device``."""
    device = resolve(device)
    if name == "rect" or name is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return _cosine_window(n, cosine_coeffs(name), periodic, device)


def cosine_coeffs(name):
    """Cosine-sum coefficients (a_0, a_1, ...) of a named window."""
    if name == "rect" or name is None:
        return (1.0,)
    try:
        return _COEFFS[name]
    except KeyError:
        raise ValueError(f"Unknown window type: {name}") from None


def window_freq_taps(name):
    """((offset, coeff), ...) circular-convolution taps such that
    DFT(n * w_periodic) = DFT(n) (*) taps for iid n (taps are the periodic
    window's DFT over S)."""
    a = cosine_coeffs(name)
    taps = [(0, float(a[0]))]
    for k in range(1, len(a)):
        c = float(((-1.0) ** k) * a[k] / 2.0)
        taps.append((k, c))
        taps.append((-k, c))
    return tuple(taps)
