"""Power map + local max + CA-CFAR detection mask over an RDS.

Counterpart of ``radar_slam_tpu/ops/cfar_pallas.py`` (K10).  Per frame of
an RDS [A, R, D]:

    p        = (1/A) sum_a |rds[a]|^2          (summed over a in order)
    power_db = 10 log10(p + 1e-12)
    is_peak  = no neighbour in the N x N window exceeds power_db (-inf
               outside the map)
    noise    = CA-CFAR on p (no 1e-12): box means over the training and
               guard windows with clipped cell counts, recombined with the
               full window areas
    mask     = is_peak & (power_db > max(10 log10(max(noise, 1e-12))
               + offset_db, threshold_db))

The box sums and maxima run separably, along range first, in the Pallas
kernel's order (centre, +1, -1, +2, -2, ...).  That kernel is what the
plain version reproduces; the reference's jnp oracle
(``cfar_pallas.py:cfar_mask_reference``) trains the CFAR on
10^(power_db / 10) instead and agrees with the kernel on > 99.9 % of cells.

- :func:`cfar_mask` -- the kernel wrapper: a CUDA tensor launches
  ``cube_cfar`` of ``csrc/cube.cu`` (one block per tile of range rows and
  frame, each with a halo of rows) or raises; a CPU tensor runs
  :func:`cfar_mask_reference`.  ``cfar_mask.launches`` counts the CUDA
  launches.
- :func:`cfar_tile_plan` -- the kernel's tile of range rows, halo and
  shared memory for a map shape, or the reason it cannot take it.
- :func:`cfar_mask_reference` -- the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from radar_slam_tpu_torch.ops import _build

_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)
# Shared memory of a block when two share an SM (228 KB an SM, 1 KB of it
# reserved per block).
_TWO_PER_SM = 233472 // 2 - 1024
_RB = 4               # csrc/cube.cu: CFAR_RB, cells a thread's sums take
# Candidate tiles (multiples of _RB), largest first.  No more than 32: at
# the bench map (R = 400, D = 32, a halo of 10) T = 32 ran faster than 64,
# more blocks outweighing the halo read again (the tile sweep on an H100
# when K10 took range tiles: CHANGES.md, PERF.md).
_TILE_ROWS = (32, 16, 8, 4)
_LOG10_E = 0.4342944819032518      # 1 / ln(10), as jnp.log10 multiplies


def db10(x: torch.Tensor) -> torch.Tensor:
    """10 log10(x) with the reference's operation order."""
    return 10.0 * (torch.log(x) * _LOG10_E)


def _shifted(x: torch.Tensor, k: int, dim: int, fill: float) -> torch.Tensor:
    """y[..., i, ...] = x[..., i + k, ...] along ``dim``, ``fill`` past the
    edge."""
    n = x.shape[dim]
    if abs(k) >= n:
        return torch.full_like(x, fill)
    body = x.narrow(dim, max(k, 0), n - abs(k))
    pad = torch.full_like(x.narrow(dim, 0, abs(k)), fill)
    return torch.cat([body, pad] if k > 0 else [pad, body], dim)


def _sep_reduce(x: torch.Tensor, half: int, op, fill: float) -> torch.Tensor:
    """Separable (2 half + 1)^2 window reduction over the last two axes
    [..., R, D], range first."""
    acc = x
    for k in range(1, half + 1):
        acc = op(acc, _shifted(x, k, -2, fill))
        acc = op(acc, _shifted(x, -k, -2, fill))
    out = acc
    for k in range(1, half + 1):
        out = op(out, _shifted(acc, k, -1, fill))
        out = op(out, _shifted(acc, -k, -1, fill))
    return out


def _counts(R: int, D: int, half: int, device) -> torch.Tensor:
    """In-bounds cell count [R, D] of each (2 half + 1)^2 window."""
    def count(n):
        i = torch.arange(n, device=device)
        return (torch.clamp(i, max=half)
                + torch.clamp(n - 1 - i, min=0, max=half) + 1
                ).to(torch.float32)
    return count(R)[:, None] * count(D)[None, :]


def cfar_mask_reference(rds: torch.Tensor, threshold_db: float = -25.0,
                        neighborhood: int = 3, train: int = 0,
                        guard: int = 0, offset_db: float = 12.0):
    """(power_db [..., R, D] float32, mask [..., R, D] bool) of an RDS
    [..., A, R, D] in plain PyTorch."""
    A, R, D = rds.shape[-3:]
    p = None
    for a in range(A):
        x = rds[..., a, :, :]
        t = x.real * x.real + x.imag * x.imag
        p = t if p is None else p + t
    p = p * (1.0 / A)
    power_db = db10(p + 1e-12)
    local_max = _sep_reduce(power_db, neighborhood // 2, torch.maximum,
                            -float("inf"))
    is_peak = local_max == power_db
    if train > 0:
        th = train + guard
        noise = (_sep_reduce(p, th, torch.add, 0.0)
                 / _counts(R, D, th, rds.device))
        if guard > 0:
            g = (_sep_reduce(p, guard, torch.add, 0.0)
                 / _counts(R, D, guard, rds.device))
            t2 = float((2 * th + 1) ** 2)
            g2 = float((2 * guard + 1) ** 2)
            noise = (noise * t2 - g * g2) / (t2 - g2)
        thresh = torch.clamp(db10(torch.clamp(noise, min=1e-12)) + offset_db,
                             min=threshold_db)
    else:
        thresh = threshold_db
    return power_db, is_peak & (power_db > thresh)


def _check(rds: torch.Tensor, neighborhood: int, train: int,
           guard: int) -> None:
    if rds.dim() < 3:
        raise ValueError(f"rds: need [..., A, R, D], got {tuple(rds.shape)}")
    _build.check_input("rds", rds, torch.complex64, rds.device)
    if neighborhood < 1 or neighborhood % 2 != 1:
        raise ValueError("neighborhood must be odd and positive")
    if train < 0 or guard < 0:
        raise ValueError("train and guard must be >= 0")


def _smem_bytes(T: int, D: int, halo: int, train: int, guard: int,
                neighborhood: int) -> int:
    """Shared memory (bytes) of ``csrc/cube.cu:cfar_kernel`` with tiles of
    T rows, in the order the kernel lays it out: the power / dB rows of the
    tile and its halo with nh = neighborhood // 2 border columns, then
    (where the CFAR runs, train > 0) the range-axis training sums of the
    own rows with train + guard border columns, then (and guard > 0) the
    guard sums with guard border columns, each buffer followed by _RB
    floats of slack, then a byte per own cell for the CFAR test.  Each
    row's pitch is odd (``cfar_pitch``)."""
    th, nh = train + guard, neighborhood // 2
    fl = (T + 2 * halo) * ((D + 2 * nh) | 1) + _RB
    if train > 0:
        fl += T * ((D + 2 * th) | 1) + _RB
        if guard > 0:
            fl += T * ((D + 2 * guard) | 1) + _RB
    return 4 * fl + T * D


@functools.lru_cache(maxsize=None)
def cfar_tile_plan(R: int, D: int, train: int, guard: int,
                   neighborhood: int):
    """(T, halo, shared-memory bytes) of ``csrc/cube.cu:cube_cfar`` for a
    map [R, D]: each block owns T range rows and holds the power of its
    rows plus ``halo`` = max(train + guard, neighborhood // 2) rows each
    side (train + guard only where the CFAR runs, train > 0), with the
    sums and tests of its own rows (``_smem_bytes``).  T is the largest of
    32, 16, 8, 4 with which two blocks share an SM, else the largest that
    fits one block (no more than R rounded up to 4).  A thread's range
    sums take four rows, so the smallest tile is four rows; raises where
    even that does not fit."""
    halo = max(train + guard if train > 0 else 0, neighborhood // 2)

    def smem(T):
        return _smem_bytes(T, D, halo, train, guard, neighborhood)

    cap = -(-R // _RB) * _RB
    for limit in (_TWO_PER_SM, _MAX_SMEM):
        for T in _TILE_ROWS:
            if smem(T) <= limit:
                return min(T, cap), halo, smem(min(T, cap))
    raise ValueError(
        f"D={D} Doppler bins with a halo of {halo} rows (train + guard = "
        f"{train + guard}, neighborhood {neighborhood}): a tile of "
        f"{_RB} range rows needs {smem(_RB)} bytes of shared memory (the "
        f"power of {_RB + 2 * halo} rows, the sums and the tests); a block "
        f"has {_MAX_SMEM}")


def _launch(rds: torch.Tensor, pdb: torch.Tensor, mask: torch.Tensor,
            T: int, halo: int, smem: int, threshold_db: float,
            neighborhood: int, train: int, guard: int,
            offset_db: float) -> None:
    """Launch ``cube_cfar`` on an RDS [..., A, R, D] on the card into
    ``pdb`` and ``mask`` [..., R, D], in tiles of T rows with ``halo`` rows
    each side and ``smem`` bytes of shared memory a block."""
    *batch, A, R, D = rds.shape
    F = 1
    for b in batch:
        F *= b
    dev = rds.device
    th = train + guard
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("cube", "cube_cfar",
                     (vp,) * 3 + (ci,) * 7 + (cf, cf) + (ci,) * 3
                     + (cf,) * 3 + (ci, vp))
    _build.launch(fn, rds.data_ptr(), pdb.data_ptr(), mask.data_ptr(),
                  F, A, R, D, T, halo, smem, float(1.0 / A),
                  float(threshold_db), neighborhood, train, guard,
                  float(offset_db), float((2 * th + 1) ** 2),
                  float((2 * guard + 1) ** 2), dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)


def cfar_mask(rds: torch.Tensor, threshold_db: float = -25.0,
              neighborhood: int = 3, train: int = 0, guard: int = 0,
              offset_db: float = 12.0):
    """(power_db [..., R, D] float32, mask [..., R, D] bool) of an RDS
    [..., A, R, D] complex64.  A CUDA tensor launches the kernel or raises;
    a CPU tensor runs the plain version."""
    _check(rds, neighborhood, train, guard)
    if rds.device.type == "cuda":
        *batch, A, R, D = rds.shape
        T, halo, smem = cfar_tile_plan(R, D, train, guard, neighborhood)
        dev = rds.device
        pdb = torch.empty((*batch, R, D), dtype=torch.float32, device=dev)
        mask = torch.empty((*batch, R, D), dtype=torch.bool, device=dev)
        if pdb.numel() == 0:
            return pdb, mask
        _launch(rds, pdb, mask, T, halo, smem, threshold_db, neighborhood,
                train, guard, offset_db)
        cfar_mask.launches += 1
        return pdb, mask
    if rds.device.type == "cpu":
        return cfar_mask_reference(rds, threshold_db, neighborhood, train,
                                   guard, offset_db)
    raise ValueError(f"no CFAR kernel for device {rds.device}")


cfar_mask.launches = 0
