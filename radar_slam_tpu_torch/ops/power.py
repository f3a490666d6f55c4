"""ADC cube -> non-coherent range-Doppler power map, without the RDS cube.

Counterpart of ``radar_slam_tpu/ops/power_pallas.py`` (K7).  Per frame:
Z = X @ W_rng (dechirp mix, DC projector and e^{+j} range DFT), then per
antenna the Doppler DFT, |.|^2 and the mean over antennas, in the
detection layout [..., R, D] (range unshifted, Doppler fftshifted).

- :func:`rds_power_fused` -- the kernel wrapper.  On a CUDA tensor it
  launches the hand-written kernel of ``csrc/cube.cu`` (``cube_rds_power``:
  the on-chip cube kernel of ``csrc/cube_onchip.cuh`` fed by loads, the
  range DFT as the factored FFT of ``ops/range_dft.py``) or raises; on a
  CPU tensor it runs :func:`rds_power_reference`.  ``.launches`` counts
  the CUDA launches, ``.branch_launches`` those of the non-default routes
  ("dense_range", "cluster_rows": C > 32).
- :func:`rds_power_reference` -- the plain version: the two DFT products
  of ``signal/rds.py:_rds_matmul`` (the reference's range constant) in
  float32, then the antenna mean.
- :func:`rds_power_factored_reference` -- the kernel's own order in plain
  PyTorch: the factored range DFT, the Doppler constant, the mean.

The TPU kernel's range product defaults to one bf16 pass; the port runs
it in float32 (ROADMAP, Port conventions).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from radar_slam_tpu_torch.ops import _build, range_dft
from radar_slam_tpu_torch.ops.frontend import (count_onchip,
                                               cube_onchip_limits,
                                               doppler_constant,
                                               range_fft_args)

_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)
_PS = 32              # csrc/cube.cu: range bins per Doppler block (K8)


def rds_power_reference(signals: torch.Tensor, mix: torch.Tensor,
                        dc_removal: bool = True,
                        doppler_window: Optional[str] = None
                        ) -> torch.Tensor:
    """Power map [..., S, C] of cubes [..., A, C, S] in plain PyTorch."""
    from radar_slam_tpu_torch.signal.rds import _rds_matmul
    rds = _rds_matmul(signals, mix, dc_removal, doppler_window)
    return torch.mean(rds.abs() ** 2, dim=-3)


def rds_power_factored_reference(signals: torch.Tensor, mix: torch.Tensor,
                                 dc_removal: bool = True,
                                 doppler_window: Optional[str] = None
                                 ) -> torch.Tensor:
    """K7 in the kernel's order, in plain PyTorch: the rows through the
    factored range DFT (``range_dft_factored_reference``, the exact DFT's
    float64-built twiddles), the Doppler constant K4 takes, |.|^2, the
    mean over antennas.  Power map [..., S, C] of cubes [..., A, C, S]."""
    z = range_dft.range_dft_factored_reference(signals, mix, dc_removal)
    w_dop_t = doppler_constant(signals.shape[-2], doppler_window,
                               signals.device).to(z.dtype)
    o = w_dop_t @ z                                        # [..., A, D, S]
    p = torch.mean(o.real * o.real + o.imag * o.imag, dim=-3)
    return p.transpose(-1, -2)


def check_cube(signals: torch.Tensor, mix: torch.Tensor):
    """Shape, type and placement checks shared by the cube kernels'
    wrappers.  Returns (batch shape, F, A, C, S)."""
    if signals.dim() < 3:
        raise ValueError(f"signals: need [..., A, C, S], got "
                         f"{tuple(signals.shape)}")
    *batch, A, C, S = signals.shape
    _build.check_input("signals", signals, torch.complex64, signals.device)
    _build.check_input("mix", mix, torch.complex64, signals.device, (S,))
    F = 1
    for b in batch:
        F *= b
    return tuple(batch), F, A, C, S


def range_product_launch(symbol: str, signals: torch.Tensor,
                         mix: torch.Tensor, dc_removal: bool,
                         doppler_window: Optional[str], out: torch.Tensor,
                         *extra):
    """Launch ``cube_rds`` (K8) of ``csrc/cube.cu`` into ``out``: the
    range product on the reference's dense constant into a Z scratch
    [F, A*C, S], then the Doppler stage."""
    from radar_slam_tpu_torch.signal.rds import range_dft_matrix
    _, F, A, C, S = check_cube(signals, mix)
    if not 0 < F <= 65535:
        raise ValueError(f"F={F} frames: the kernel takes 1..65535")
    smem = 4 * (2 * A * C * _PS + 2 * C * (C + 1))
    if smem > _MAX_SMEM:
        raise ValueError(f"A={A}, C={C} needs {smem} bytes of shared memory "
                         f"per block; the kernel has {_MAX_SMEM}")
    dev = signals.device
    w_rng = range_dft_matrix(S, mix, dc_removal).contiguous()
    w_dop_t = doppler_constant(C, doppler_window, dev)
    z = torch.empty((F, A * C, S), dtype=torch.complex64, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    extra_types = tuple(cf for _ in extra)
    fn = _build.bind("cube", symbol,
                     (vp,) * 5 + (ci,) * 4 + extra_types + (ci, vp))
    _build.launch(fn, signals.data_ptr(), w_rng.data_ptr(),
                  w_dop_t.data_ptr(), z.data_ptr(), out.data_ptr(), F, A, C,
                  S, *extra, dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)


def rds_power_fused(signals: torch.Tensor, mix: torch.Tensor,
                    dc_removal: bool = True,
                    doppler_window: Optional[str] = None) -> torch.Tensor:
    """Power map [..., S, C] (float32, ``mean_a |rds|^2`` in the detection
    layout [range, Doppler]) of cubes [..., A, C, S] complex64; ``mix`` [S]
    is the dechirp x fast-time-window vector.  A CUDA tensor launches the
    kernel or raises; a CPU tensor runs the plain version."""
    if signals.device.type == "cuda":
        batch, F, A, C, S = check_cube(signals, mix)
        if not 0 < F <= 65535:
            raise ValueError(f"F={F} frames: the kernel takes 1..65535")
        route = cube_onchip_limits(C, S)
        dev = signals.device
        w_dop_t = doppler_constant(C, doppler_window, dev)
        tw, pos, nst, radix = range_fft_args(S, dev)
        # Per-antenna power planes [F, A, S, C], summed in antenna order.
        pa = torch.empty((F, A, S, C), dtype=torch.float32, device=dev)
        out = torch.empty((*batch, S, C), dtype=torch.float32, device=dev)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = _build.bind("cube", "cube_rds_power",
                         (vp,) * 4 + (ci,) + (vp,) * 4 + (ci,) * 4
                         + (cf, ci, ci, vp))
        _build.launch(fn, signals.data_ptr(), mix.data_ptr(), tw.data_ptr(),
                      pos.data_ptr(), nst, radix, w_dop_t.data_ptr(),
                      pa.data_ptr(), out.data_ptr(), F, A, C, S,
                      float(1.0 / A), int(dc_removal), dev.index,
                      torch.cuda.current_stream(dev).cuda_stream)
        count_onchip(rds_power_fused, S, route)
        return out
    if signals.device.type == "cpu":
        check_cube(signals, mix)
        return rds_power_reference(signals, mix, dc_removal, doppler_window)
    raise ValueError(f"no power kernel for device {signals.device}")


rds_power_fused.launches = 0
rds_power_fused.branch_launches = {"dense_range": 0, "cluster_rows": 0}
