"""Static-shape tensor types flowing between pipeline stages.

Counterpart of ``radar_slam_tpu/core/types.py``.  The port has no ``vmap``,
so every type carries the leading frame axis written out: a field the
reference documents as ``[K]`` is ``[F, K]`` here, ``[K, A]`` is
``[F, K, A]`` and a per-frame scalar is ``[F]``.  Integer fields are int32
and complex fields complex64, as in the reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


class ScattererBatch(NamedTuple):
    """Padded scatterer sets [F, S] (``ScattererBatch`` in the reference)."""

    range_m: torch.Tensor      # [F, S] float32
    azimuth_rad: torch.Tensor  # [F, S] float32
    rcs_db: torch.Tensor       # [F, S] float32
    vr: torch.Tensor           # [F, S] float32 radial velocity [m/s]
    valid: torch.Tensor        # [F, S] bool
    elevation_rad: Optional[torch.Tensor] = None  # [F, S] float32 or None


_SCATTERER_FIELDS = ("range_m", "azimuth_rad", "rcs_db", "vr", "valid",
                     "elevation_rad")


def scatterer_batch_from_numpy(fields: Dict[str, np.ndarray],
                               device) -> ScattererBatch:
    """Build a :class:`ScattererBatch` on ``device`` from numpy columns.

    ``fields`` maps the ``ScattererBatch`` field names to arrays with a
    leading frame axis -- the scene generator's columns, or the fields of
    a reference batch read back as numpy.  Values are copied bit for bit
    (float32 / bool); ``elevation_rad`` may be absent or None."""
    unknown = set(fields) - set(_SCATTERER_FIELDS)
    if unknown:
        raise ValueError(f"unknown scatterer fields: {sorted(unknown)}")

    def col(name, dtype):
        return torch.from_numpy(
            np.array(fields[name], dtype=dtype, order="C")).to(device)

    el = fields.get("elevation_rad")
    return ScattererBatch(
        range_m=col("range_m", np.float32),
        azimuth_rad=col("azimuth_rad", np.float32),
        rcs_db=col("rcs_db", np.float32),
        vr=col("vr", np.float32),
        valid=col("valid", np.bool_),
        elevation_rad=(col("elevation_rad", np.float32)
                       if el is not None else None))


def signals_from_numpy(x: np.ndarray, device) -> torch.Tensor:
    """ADC cubes [F, A, C, S] complex64 on ``device``, copied from a numpy
    array (a reference cube read back, or one made with numpy).  Raises
    unless ``x`` is complex64 with four axes."""
    x = np.asarray(x)
    if x.dtype != np.complex64:
        raise TypeError(f"signals: dtype {x.dtype} != complex64")
    if x.ndim != 4:
        raise ValueError(f"signals: need [F, A, C, S], got shape {x.shape}")
    return torch.from_numpy(np.array(x, order="C")).to(device)


class Detections(NamedTuple):
    """Top-K range-Doppler detections [F, K] (static shape, masked)."""

    range_bin: torch.Tensor    # [F, K] int32
    doppler_bin: torch.Tensor  # [F, K] int32
    range_m: torch.Tensor      # [F, K] float32
    doppler_hz: torch.Tensor   # [F, K] float32
    vr_mps: torch.Tensor       # [F, K] float32
    power_db: torch.Tensor     # [F, K] float32
    valid: torch.Tensor        # [F, K] bool


class Targets(NamedTuple):
    """Detections augmented with AoA estimates + quality metrics [F, K]."""

    range_bin: torch.Tensor          # [F, K] int32
    doppler_bin: torch.Tensor        # [F, K] int32
    range_m: torch.Tensor            # [F, K] float32
    doppler_hz: torch.Tensor         # [F, K] float32
    vr_mps: torch.Tensor             # [F, K] float32
    power_db: torch.Tensor           # [F, K] float32
    azimuth_rad: torch.Tensor        # [F, K] float32
    confidence: torch.Tensor         # [F, K] float32
    num_sources: torch.Tensor        # [F, K] int32 (MDL model order)
    is_multipath: torch.Tensor       # [F, K] bool
    is_reliable: torch.Tensor        # [F, K] bool
    spatial_signature: torch.Tensor  # [F, K, A] complex64, unit power
    valid: torch.Tensor              # [F, K] bool
    elevation_rad: Optional[torch.Tensor] = None  # [F, K] float32 or None

    @property
    def position(self) -> torch.Tensor:
        """Cartesian positions [F, K, 3] (el = 0 when azimuth-only)."""
        if self.elevation_rad is None:
            z = torch.zeros_like(self.range_m)
            ce = 1.0
        else:
            z = self.range_m * torch.sin(self.elevation_rad)
            ce = torch.cos(self.elevation_rad)
        return torch.stack([ce * self.range_m * torch.cos(self.azimuth_rad),
                            ce * self.range_m * torch.sin(self.azimuth_rad),
                            z], dim=-1)


class Associations(NamedTuple):
    """Cross-frame target associations [F, K] (static shape, masked)."""

    prev_index: torch.Tensor           # [F, K] int32
    distance: torch.Tensor             # [F, K] float32
    temporal_phase_diff: torch.Tensor  # [F, K] float32
    position: torch.Tensor             # [F, K, 3] float32
    direction: torch.Tensor            # [F, K, 3] float32 unit LOS
    vr_mps: torch.Tensor               # [F, K] float32
    apparent_velocity: torch.Tensor    # [F, K, 3] float32
    weight: torch.Tensor               # [F, K] float32
    valid: torch.Tensor                # [F, K] bool

    @property
    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)


class MotionEstimate(NamedTuple):
    """Per-frame 6-DoF motion solve results [F, ...]."""

    velocity: torch.Tensor          # [F, 3] float32
    angular_velocity: torch.Tensor  # [F, 3] float32
    rmse: torch.Tensor              # [F] float32
    max_residual: torch.Tensor      # [F] float32
    num_targets: torch.Tensor       # [F] int32
    success: torch.Tensor           # [F] bool
    cost: torch.Tensor              # [F] float32

    @property
    def params(self) -> torch.Tensor:
        return torch.cat([self.velocity, self.angular_velocity], dim=-1)


class Trajectory(NamedTuple):
    """Integrated pose trajectory of N frames (the reference's
    ``Trajectory``; a sequence, so no extra frame axis)."""

    timestamps: torch.Tensor          # [N] float32 seconds
    positions: torch.Tensor           # [N, 3]
    orientations: torch.Tensor        # [N, 3] Euler xyz (roll, pitch, yaw)
    quaternions: torch.Tensor         # [N, 4] (w, x, y, z)
    velocities: torch.Tensor          # [N, 3]
    angular_velocities: torch.Tensor  # [N, 3]

    @property
    def rotations(self) -> torch.Tensor:
        from radar_slam_tpu_torch.core import geometry
        return geometry.quat_to_matrix(self.quaternions)

    @property
    def total_distance(self) -> torch.Tensor:
        steps = torch.diff(self.positions, dim=0)
        return torch.sum(torch.linalg.vector_norm(steps, dim=-1))

    @property
    def duration(self) -> torch.Tensor:
        return self.timestamps[-1] - self.timestamps[0]


class FrameOutput(NamedTuple):
    """Per-frame pipeline outputs (``pipeline/frame.py:FrameOutput`` in the
    reference), leading frame axis [F]."""

    motion: MotionEstimate
    pose: torch.Tensor              # [F, 3] planar (x, y, yaw) after frame
    num_detections: torch.Tensor    # [F] int32
    num_reliable: torch.Tensor      # [F] int32
    num_associations: torch.Tensor  # [F] int32
    target_xy: torch.Tensor         # [F, K, 2] float32 body-frame positions
    target_valid: torch.Tensor      # [F, K] bool (valid & reliable)
    target_z: torch.Tensor          # [F, K] float32 heights (0 on a ULA)
