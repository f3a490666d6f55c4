"""Frozen copy of ``ScattererBatch`` of ``radar_slam_tpu_torch/core/types.py``
at commit d8c8661: the reference front end's input."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ScattererBatch(NamedTuple):
    """Padded scatterer sets [F, S] (``ScattererBatch`` in the reference)."""

    range_m: torch.Tensor      # [F, S] float32
    azimuth_rad: torch.Tensor  # [F, S] float32
    rcs_db: torch.Tensor       # [F, S] float32
    vr: torch.Tensor           # [F, S] float32 radial velocity [m/s]
    valid: torch.Tensor        # [F, S] bool
    elevation_rad: Optional[torch.Tensor] = None  # [F, S] float32 or None
