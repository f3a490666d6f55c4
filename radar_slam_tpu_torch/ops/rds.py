"""ADC cube -> complex range-Doppler spectrum in one kernel.

Counterpart of ``radar_slam_tpu/ops/rds_pallas.py`` (K8): the range
product of ``ops/power.py`` (dechirp mix, DC projector and e^{+j} range
DFT as one [S, S] matrix), then the complex Doppler DFT with the slow-time
window and the fftshift in W_dop's column order.

- :func:`rds_fused` -- the kernel wrapper: a CUDA tensor launches
  ``cube_rds`` of ``csrc/cube.cu`` or raises; a CPU tensor runs
  :func:`rds_fused_reference`.  ``rds_fused.launches`` counts the CUDA
  launches.
- :func:`rds_fused_reference` -- the plain version,
  ``signal/rds.py:_rds_matmul`` in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from radar_slam_tpu_torch.ops.power import check_cube, range_product_launch


def rds_fused_reference(signals: torch.Tensor, mix: torch.Tensor,
                        dc_removal: bool = True,
                        doppler_window: Optional[str] = None
                        ) -> torch.Tensor:
    """RDS [..., A, S, C] of cubes [..., A, C, S] in plain PyTorch."""
    from radar_slam_tpu_torch.signal.rds import _rds_matmul
    return _rds_matmul(signals, mix, dc_removal, doppler_window)


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
        range_product_launch("cube_rds", signals, mix, dc_removal,
                             doppler_window, out)
        rds_fused.launches += 1
        return out
    if signals.device.type == "cpu":
        check_cube(signals, mix)
        return rds_fused_reference(signals, mix, dc_removal, doppler_window)
    raise ValueError(f"no RDS kernel for device {signals.device}")


rds_fused.launches = 0
