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
  ``cube_cfar`` of ``csrc/cube.cu`` or raises; a CPU tensor runs
  :func:`cfar_mask_reference`.  ``cfar_mask.launches`` counts the CUDA
  launches.
- :func:`cfar_mask_reference` -- the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from radar_slam_tpu_torch.ops import _build

_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)
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


def cfar_mask(rds: torch.Tensor, threshold_db: float = -25.0,
              neighborhood: int = 3, train: int = 0, guard: int = 0,
              offset_db: float = 12.0):
    """(power_db [..., R, D] float32, mask [..., R, D] bool) of an RDS
    [..., A, R, D] complex64.  A CUDA tensor launches the kernel or raises;
    a CPU tensor runs the plain version."""
    _check(rds, neighborhood, train, guard)
    if rds.device.type == "cuda":
        *batch, A, R, D = rds.shape
        F = 1
        for b in batch:
            F *= b
        smem = 4 * 2 * R * D
        if smem > _MAX_SMEM:
            raise ValueError(f"R={R}, D={D} needs {smem} bytes of shared "
                             f"memory per block; the kernel has {_MAX_SMEM}")
        dev = rds.device
        pdb = torch.empty((*batch, R, D), dtype=torch.float32, device=dev)
        mask = torch.empty((*batch, R, D), dtype=torch.bool, device=dev)
        if F == 0:
            return pdb, mask
        th = train + guard
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = _build.bind("cube", "cube_cfar",
                         (vp, vp, vp, ci, ci, ci, ci, cf, cf, ci, ci, ci,
                          cf, cf, cf, ci, vp))
        _build.launch(fn, rds.data_ptr(), pdb.data_ptr(), mask.data_ptr(),
                      F, A, R, D, float(1.0 / A), float(threshold_db),
                      neighborhood, train, guard, float(offset_db),
                      float((2 * th + 1) ** 2), float((2 * guard + 1) ** 2),
                      dev.index, torch.cuda.current_stream(dev).cuda_stream)
        cfar_mask.launches += 1
        return pdb, mask
    if rds.device.type == "cpu":
        return cfar_mask_reference(rds, threshold_db, neighborhood, train,
                                   guard, offset_db)
    raise ValueError(f"no CFAR kernel for device {rds.device}")


cfar_mask.launches = 0
