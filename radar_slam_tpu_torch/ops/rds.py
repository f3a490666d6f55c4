"""ADC cube -> complex range-Doppler spectrum in one kernel.

Counterpart of ``radar_slam_tpu/ops/rds_pallas.py`` (K8): per antenna the
rows times the dechirp x window mix, their e^{+j} range DFT with the DC
bin zeroed, then the complex Doppler DFT with the slow-time window and the
fftshift in W_dop's column order.

- :func:`rds_fused` -- the kernel wrapper: a CUDA tensor launches
  ``cube_rds`` of ``csrc/cube.cu`` (the on-chip cube kernel of
  ``csrc/cube_onchip.cuh`` fed by loads, with the complex-RDS consumer; the
  range DFT as the factored FFT of ``ops/range_dft.py``) or raises; a CPU
  tensor runs :func:`rds_fused_reference`.  ``rds_fused.launches`` counts
  the CUDA launches, ``.branch_launches`` those of the non-default routes
  ("dense_range", "cluster_rows": C > 32).
- :func:`rds_fused_reference` -- the plain version,
  ``signal/rds.py:_rds_matmul`` (the reference's range constant) in
  float32.
- :func:`rds_fused_factored_reference` -- the kernel's own order in plain
  PyTorch: the factored range DFT, then the Doppler constant.
"""

from __future__ import annotations

from typing import Optional

import torch

from radar_slam_tpu_torch.ops import range_dft
from radar_slam_tpu_torch.ops.frontend import doppler_constant
from radar_slam_tpu_torch.ops.power import check_cube, cube_onchip_launch


def rds_fused_reference(signals: torch.Tensor, mix: torch.Tensor,
                        dc_removal: bool = True,
                        doppler_window: Optional[str] = None
                        ) -> torch.Tensor:
    """RDS [..., A, S, C] of cubes [..., A, C, S] in plain PyTorch."""
    from radar_slam_tpu_torch.signal.rds import _rds_matmul
    return _rds_matmul(signals, mix, dc_removal, doppler_window)


def rds_fused_factored_reference(signals: torch.Tensor, mix: torch.Tensor,
                                 dc_removal: bool = True,
                                 doppler_window: Optional[str] = None
                                 ) -> torch.Tensor:
    """K8 in the kernel's order, in plain PyTorch: the rows through the
    factored range DFT (``range_dft_factored_reference``, the exact DFT's
    float64-built twiddles), then the Doppler constant K7 takes.  RDS
    [..., A, S, C] of cubes [..., A, C, S]."""
    z = range_dft.range_dft_factored_reference(signals, mix, dc_removal)
    w_dop_t = doppler_constant(signals.shape[-2], doppler_window,
                               signals.device).to(z.dtype)
    return (w_dop_t @ z).transpose(-1, -2)


def rds_fused(signals: torch.Tensor, mix: torch.Tensor,
              dc_removal: bool = True,
              doppler_window: Optional[str] = None) -> torch.Tensor:
    """RDS [..., A, S, C] complex64 (range unshifted, Doppler fftshifted)
    of cubes [..., A, C, S] complex64; ``mix`` [S] is the dechirp x
    fast-time-window vector.  A CUDA tensor launches the kernel or raises;
    a CPU tensor runs the plain version."""
    if signals.device.type == "cuda":
        batch, _, A, C, S = check_cube(signals, mix)
        out = torch.empty((*batch, A, S, C), dtype=torch.complex64,
                          device=signals.device)
        cube_onchip_launch(rds_fused, "cube_rds", signals, mix, dc_removal,
                           doppler_window, (out,))
        return out
    if signals.device.type == "cpu":
        check_cube(signals, mix)
        return rds_fused_reference(signals, mix, dc_removal, doppler_window)
    raise ValueError(f"no RDS kernel for device {signals.device}")


rds_fused.launches = 0
rds_fused.branch_launches = {"dense_range": 0, "cluster_rows": 0}
