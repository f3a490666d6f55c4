"""Geometry primitives the batched slice uses: angle wrapping, ULA steering
vectors, line-of-sight directions.

Counterpart of ``radar_slam_tpu/core/geometry.py`` (same conventions: the
ULA element n sits at n * spacing, steering phase 2 pi n d sin(az) /
lambda).  Every function is float32 in, float32 / complex64 out, with the
reference's operation order so results agree to float rounding.
"""

from __future__ import annotations

import math

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def antenna_positions(num_antennas: int, spacing: float,
                      device=None) -> torch.Tensor:
    """ULA element positions [A]."""
    return torch.arange(num_antennas, dtype=torch.float32,
                        device=device) * spacing


def steering_vector(azimuth_rad: torch.Tensor, num_antennas: int,
                    spacing: float, lambda_c: float) -> torch.Tensor:
    """a_n(az) = exp(j 2 pi n d sin(az) / lambda): complex64 [..., A]."""
    az = torch.as_tensor(azimuth_rad, dtype=torch.float32)
    pos = antenna_positions(num_antennas, spacing, az.device)       # [A]
    phase = (2.0 * math.pi / lambda_c) * torch.sin(az)[..., None] * pos
    return torch.polar(torch.ones_like(phase), phase)


def steering_matrix(grid_rad: torch.Tensor, num_antennas: int,
                    spacing: float, lambda_c: float) -> torch.Tensor:
    """Steering matrix over an angle grid: [G, A] complex64."""
    return steering_vector(grid_rad, num_antennas, spacing, lambda_c)


def direction_vector(azimuth_rad: torch.Tensor,
                     elevation_rad: torch.Tensor) -> torch.Tensor:
    """Unit line-of-sight direction(s) [..., 3]:
    [cos el cos az, cos el sin az, sin el]."""
    az = torch.as_tensor(azimuth_rad, dtype=torch.float32)
    el = torch.as_tensor(elevation_rad, dtype=torch.float32)
    return torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az),
                        torch.sin(el)], dim=-1)


def polar_to_cartesian(range_m: torch.Tensor, azimuth_rad: torch.Tensor,
                       elevation_rad=0.0) -> torch.Tensor:
    """Target position(s) [..., 3] from polar detection coordinates."""
    r = torch.as_tensor(range_m, dtype=torch.float32)
    el = torch.zeros_like(r) + elevation_rad
    return r[..., None] * direction_vector(azimuth_rad, el)
