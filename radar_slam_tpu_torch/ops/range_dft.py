"""The range DFT of the front-end kernels, factored: its radix plan, its
twiddle table and its plain version.

The range chain of every scatterer front end is

    Y = (x * mix) @ W,   W[s, r] = e^{+2j pi s r / S},   Y[..., 0] = 0 with
                                                        dc_removal

-- the function of ``signal/rds.py:range_dft_matrix`` -- over rows x [.., S].
The kernels (``csrc/range_fft.cuh``) run it as an in-place mixed-radix
decimation-in-time FFT in shared memory: the rows are stored at the
positions of :func:`input_positions` (the digit reversal of the plan), then
one stage per radix of :func:`plan` (2, 3, 4 or 5) turns them into the
natural-order spectrum.  Stage t of radix R on sub-transforms of length
L = Q_0 ... Q_t (Lp = L / R):

    v[r] = x[b L + j + r Lp] * w[(j r S / L) mod S]       r < R, j < Lp
    x[b L + j + q Lp] = sum_r v[r] w[((r q) mod R) S / R]  q < R

with one table w[k] = e^{+2j pi k / S} (:func:`twiddles`), built in float64
and rounded to float32 once: no trigonometry in the kernels.  An S with a
prime factor above 5 has no plan; the kernels then take the dense route
(the same table, O(S^2) per row).

:func:`range_dft_factored_reference` is that stage order in PyTorch and
:func:`range_columns_exact` columns of the same transform.
``range_dft_matrix`` (the reference's constant, whose float32 phases reach
~2.5e3 rad and carry errors up to ~1e-4 rad) differs from it by ~7e-5 of
max|Y| (``tests/test_torch_range_dft.py``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.core.device import DEFAULT, resolve

RADICES = (4, 2, 3, 5)   # the order in which plan() takes factors of S
MAX_STAGES = 16          # csrc/range_fft.cuh: FftPlan::radix


@functools.lru_cache(maxsize=None)
def plan(S: int) -> Optional[Tuple[int, ...]]:
    """The radices of the stages for S (their product is S), or None where
    S has a prime factor above 5 (the dense route)."""
    if S < 1:
        raise ValueError(f"S={S}: need at least one sample")
    out, n = [], S
    for r in RADICES:
        while n % r == 0:
            out.append(r)
            n //= r
    if n != 1:
        return None
    if len(out) > MAX_STAGES:
        raise ValueError(f"S={S} needs {len(out)} stages; at most "
                         f"{MAX_STAGES}")
    return tuple(out)


def _elements_at(S: int, radices: Tuple[int, ...]) -> np.ndarray:
    """elem[p]: the natural index of the sample stored at position p
    before the first stage (decimation in time, the last stage's radix
    outermost)."""
    if not radices:
        return np.zeros(1, np.int64)
    R = radices[-1]
    sub = _elements_at(S // R, radices[:-1])
    return np.concatenate([r + R * sub for r in range(R)])


@functools.lru_cache(maxsize=None)
def _positions_np(S: int) -> np.ndarray:
    radices = plan(S)
    if radices is None:
        return np.arange(S, dtype=np.int32)
    pos = np.empty(S, np.int32)
    pos[_elements_at(S, radices)] = np.arange(S, dtype=np.int32)
    return pos


def input_positions(S: int, device=DEFAULT) -> torch.Tensor:
    """[S] int32: the position at which sample s is stored before the
    first stage (the identity on the dense route)."""
    return _cached(S, str(device))[1]


def _twiddles_np(S: int) -> np.ndarray:
    k = np.arange(S, dtype=np.float64)
    w = np.exp(2j * np.pi * k / S)
    # Exact values where the float64 evaluation leaves ~1e-16 residues
    # (k S / 4 multiples: 1, j, -1, -j).
    for q, v in enumerate((1, 1j, -1, -1j)):
        if (q * S) % 4 == 0:
            w[q * S // 4] = v
    return w.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _cached(S: int, device: str):
    dev = resolve(device)
    return (torch.from_numpy(_twiddles_np(S)).to(dev),
            torch.from_numpy(_positions_np(S)).to(dev))


def twiddles(S: int, device=DEFAULT) -> torch.Tensor:
    """[S] complex64: w[k] = e^{+2j pi k / S}, built in float64 and rounded
    once; one table per (S, device)."""
    return _cached(S, str(device))[0]


def range_columns_exact(S: int, range_bin: torch.Tensor, mix: torch.Tensor,
                        dc_removal: bool) -> torch.Tensor:
    """Columns [F, S, K] of the kernels' range DFT, mix[s] w[(s r) mod S]
    (zero at r = 0 with dc_removal), at the range bins r [F, K]: the
    signature kernel's range columns on the card, so that its signatures
    and the factored range DFT of the power map are one transform."""
    s = torch.arange(S, device=mix.device, dtype=torch.int32)
    rb = range_bin.to(device=mix.device, dtype=torch.int32)
    w = twiddles(S, mix.device)[(s[None, :, None] * rb[:, None, :]) % S]
    if dc_removal:
        w = w * (rb[:, None, :] != 0)
    return mix[None, :, None] * w


def range_dft_factored_reference(x: torch.Tensor, mix: torch.Tensor,
                                 dc_removal: bool) -> torch.Tensor:
    """Y [..., S] complex64 of rows x [..., S] in the kernels' stage order
    (dense route where :func:`plan` is None)."""
    S = x.shape[-1]
    tw = twiddles(S, x.device)
    y = x * mix
    radices = plan(S)
    if radices is None:
        s = torch.arange(S, device=x.device)
        out = y @ tw[(s[:, None] * s[None, :]) % S]
    else:
        pos = input_positions(S, x.device).to(torch.int64)
        buf = torch.empty_like(y)
        buf[..., pos] = y
        lead = buf.shape[:-1]
        L = 1
        for R in radices:
            Lp, L = L, L * R
            r = torch.arange(R, device=x.device)
            j = torch.arange(Lp, device=x.device)
            pre = tw[(j[None, :] * r[:, None] * (S // L)) % S]     # [R, Lp]
            omega = tw[((r[:, None] * r[None, :]) % R) * (S // R)]  # [r, q]
            v = buf.reshape(*lead, S // L, R, Lp) * pre
            buf = torch.einsum("...brj,rq->...bqj", v, omega).reshape(
                *lead, S)
        out = buf
    if dc_removal:
        out = out.clone()
        out[..., 0] = 0
    return out


def stage_args(S: int):
    """(number of stages, radices padded to MAX_STAGES) for the kernels'
    plan argument; 0 stages selects the dense route."""
    radices = plan(S) or ()
    return len(radices), tuple(radices) + (0,) * (MAX_STAGES - len(radices))
