"""The [K]-shaped detection tail of the one-pass front end.

Counterpart of ``radar_slam_tpu/signal/detect.py`` for the batched slice:
the static range-gate interval, and the build of :class:`Detections` from
raw top-K picks (validity, cross-detection NMS, parabolic sub-bin
refinement, bin-to-metric conversion), batched over a leading frame axis.
The dense detectors (CA / OS-CFAR on a materialized power map, the clutter
map) belong to the cube-input path and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import DetectionConfig, RadarConfig
from radar_slam_tpu_torch.core.types import Detections
from radar_slam_tpu_torch.signal.rds import doppler_to_radial_velocity


def range_gate_bin_interval(cfg: RadarConfig, R: int,
                            det: DetectionConfig) -> tuple[int, int]:
    """Static inclusive bin interval [lo, hi] where the float32 range axis
    lies inside [det.min_range, det.max_range]."""
    bin_hz = cfg.sampling_rate / R
    metres_per_hz = cfg.c / (2.0 * cfg.chirp_rate)
    ranges = (np.arange(R, dtype=np.float32)
              * np.float32(bin_hz * metres_per_hz))
    ok = np.nonzero((ranges >= det.min_range)
                    & (ranges <= det.max_range))[0]
    if ok.size == 0:
        return (1, 0)      # empty gate: lo > hi masks every bin
    return (int(ok[0]), int(ok[-1]))


def detections_from_topk(p_lin: torch.Tensor, r_bin: torch.Tensor,
                         d_bin: torch.Tensor, top_vals: torch.Tensor,
                         cfg: RadarConfig, det: DetectionConfig
                         ) -> Detections:
    """:class:`Detections` [F, K] from raw top-K picks (pre-NMS bins,
    -inf ``top_vals`` for exhausted slots) and the power map [F, R, D]."""
    power_db = 10.0 * torch.log10(p_lin + 1e-12)
    return _detections_from_bins(power_db, r_bin, d_bin, top_vals, cfg, det)


def _detections_from_bins(power_db: torch.Tensor, r_bin: torch.Tensor,
                          d_bin: torch.Tensor, top_vals: torch.Tensor,
                          cfg: RadarConfig, det: DetectionConfig
                          ) -> Detections:
    F, K = r_bin.shape
    R, D = power_db.shape[-2:]
    dev = power_db.device
    r_bin = r_bin.to(torch.int64)
    d_bin = d_bin.to(torch.int64)
    valid = torch.isfinite(top_vals)

    if det.nms_radius > 0:
        # The top-K list is power-sorted: detection i is suppressed if a
        # valid j < i lies within the Chebyshev radius.
        dr = (r_bin[:, :, None] - r_bin[:, None, :]).abs()
        dd = (d_bin[:, :, None] - d_bin[:, None, :]).abs()
        close = (dr <= det.nms_radius) & (dd <= det.nms_radius)
        ar = torch.arange(K, device=dev)
        stronger = ar[None, :] < ar[:, None]
        suppressed = torch.any(close & stronger & valid[:, None, :], dim=-1)
        valid = valid & ~suppressed

    # Parabolic interpolation of the dB power through the peak and its
    # neighbours along both axes (gathers of single taps: the reference's
    # one-hot sums pick the same values exactly).
    def tap(dr_, dd_):
        r = torch.clamp(r_bin + dr_, 0, R - 1)
        d = torch.clamp(d_bin + dd_, 0, D - 1)
        return torch.gather(power_db.reshape(F, R * D), 1, r * D + d)

    y0 = tap(0, 0)

    def parabolic_frac(ym, yp):
        denom = ym - 2.0 * y0 + yp
        big = denom.abs() > 1e-9
        frac = torch.where(big, 0.5 * (ym - yp)
                           / torch.where(big, denom, 1.0), 0.0)
        return torch.clamp(frac, -0.5, 0.5)

    r_frac = parabolic_frac(tap(-1, 0), tap(1, 0))
    r_frac = torch.where((r_bin > 0) & (r_bin < R - 1), r_frac, 0.0)
    d_frac = parabolic_frac(tap(0, -1), tap(0, 1))
    d_frac = torch.where((d_bin > 0) & (d_bin < D - 1), d_frac, 0.0)

    # Both axes are affine in the bin index with the same float32
    # operations the reference's axis tables are built from.  The steps
    # are float32 values held as Python scalars: a host tensor copied to
    # the card would synchronize the stream.
    bin_hz = cfg.sampling_rate / R
    metres_per_hz = cfg.c / (2.0 * cfg.chirp_rate)
    rng_step = float(np.float32(bin_hz * metres_per_hz)) if R > 1 else 0.0
    dop_step = float(np.float32(cfg.prf) / np.float32(D))
    dop_unit = float(np.float32(1.0 / (D * cfg.pri)))
    doppler_hz = ((d_bin - D // 2).to(torch.float32) * dop_unit
                  + d_frac * dop_step)
    range_m = r_bin.to(torch.float32) * rng_step + r_frac * rng_step
    zero_i = torch.zeros_like(r_bin)
    return Detections(
        range_bin=torch.where(valid, r_bin, zero_i).to(torch.int32),
        doppler_bin=torch.where(valid, d_bin, zero_i).to(torch.int32),
        range_m=torch.where(valid, range_m, 0.0),
        doppler_hz=torch.where(valid, doppler_hz, 0.0),
        vr_mps=torch.where(valid,
                           doppler_to_radial_velocity(doppler_hz, cfg), 0.0),
        power_db=torch.where(valid, top_vals, -float("inf")),
        valid=valid,
    )
