"""ADC cube -> non-coherent range-Doppler power map, without the RDS cube.

Counterpart of ``radar_slam_tpu/ops/power_pallas.py`` (K7).  Per frame:
Z = X @ W_rng (dechirp mix, DC projector and e^{+j} range DFT folded into
one [S, S] matrix), then per antenna the Doppler DFT, |.|^2 and the mean
over antennas, in the detection layout [..., R, D] (range unshifted,
Doppler fftshifted).

- :func:`rds_power_fused` -- the kernel wrapper.  On a CUDA tensor it
  launches the hand-written kernel of ``csrc/cube.cu`` (``cube_rds_power``)
  or raises; on a CPU tensor it runs :func:`rds_power_reference`.
  ``rds_power_fused.launches`` counts the CUDA launches.
- :func:`rds_power_reference` -- the plain version: the two DFT products
  of ``signal/rds.py:_rds_matmul`` in float32, then the antenna mean.

The TPU kernel's range product defaults to one bf16 pass; the port runs
it in float32 (ROADMAP, Port conventions).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from radar_slam_tpu_torch.ops import _build

_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)
_PS = 32              # csrc/cube.cu: range bins per Doppler block


def rds_power_reference(signals: torch.Tensor, mix: torch.Tensor,
                        dc_removal: bool = True,
                        doppler_window: Optional[str] = None
                        ) -> torch.Tensor:
    """Power map [..., S, C] of cubes [..., A, C, S] in plain PyTorch."""
    from radar_slam_tpu_torch.signal.rds import _rds_matmul
    rds = _rds_matmul(signals, mix, dc_removal, doppler_window)
    return torch.mean(rds.abs() ** 2, dim=-3)


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
    """Launch ``cube_rds_power`` (K7) or ``cube_rds`` (K8) of
    ``csrc/cube.cu`` into ``out``: the range product into a Z scratch
    [F, A*C, S], then the Doppler stage."""
    from radar_slam_tpu_torch.ops.frontend import doppler_constant
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
        batch, _, A, C, S = check_cube(signals, mix)
        out = torch.empty((*batch, S, C), dtype=torch.float32,
                          device=signals.device)
        range_product_launch("cube_rds_power", signals, mix, dc_removal,
                             doppler_window, out, float(1.0 / A))
        rds_power_fused.launches += 1
        return out
    if signals.device.type == "cpu":
        check_cube(signals, mix)
        return rds_power_reference(signals, mix, dc_removal, doppler_window)
    raise ValueError(f"no power kernel for device {signals.device}")


rds_power_fused.launches = 0
