"""Static-shape range-Doppler peak detection, batched over frames.

Counterpart of ``radar_slam_tpu/signal/detect.py``: the dense detectors of
the cube-input path (power map -> local max + CA-CFAR -> range gate ->
exact top-K) on an RDS [F, A, R, D] or a power map [F, R, D], the static
range-gate interval, and the build of :class:`Detections` from raw top-K
picks (validity, cross-detection NMS, parabolic sub-bin refinement,
bin-to-metric conversion) that the one-pass front end shares.  The CFAR is
cell-averaging ("ca") or order-statistic ("os", :func:`_os_noise`).  The
sequential drivers carry an EMA background power map (the clutter map,
:func:`clutter_map_update`) that gates every detector: a cell must exceed
it by ``clutter_offset_db``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tfn

from radar_slam_tpu_torch.core.config import DetectionConfig, RadarConfig
from radar_slam_tpu_torch.core.types import Detections
from radar_slam_tpu_torch.ops.cfar import db10
from radar_slam_tpu_torch.ops.frontend import topk_exact
from radar_slam_tpu_torch.signal.rds import doppler_to_radial_velocity


def _window1d(x: torch.Tensor, size: int, dim: int, fill: float,
              op: str) -> torch.Tensor:
    """Centered width-``size`` window reduction ("max" or "sum") along
    ``dim`` (-2 or -1) of [..., R, D], the edge extended with ``fill``."""
    pad = size // 2
    xp = tfn.pad(x, (pad, pad) if dim == -1 else (0, 0, pad, pad),
                 value=fill)
    win = xp.unfold(dim, size, 1)
    return win.amax(-1) if op == "max" else win.sum(-1)


def _maxpool2d_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """Max filter with SAME (-inf) padding over the last two axes."""
    return _window1d(_window1d(x, size, -2, -float("inf"), "max"), size, -1,
                     -float("inf"), "max")


def _box_sum2d(x: torch.Tensor, size: int) -> torch.Tensor:
    return _window1d(_window1d(x, size, -2, 0.0, "sum"), size, -1, 0.0,
                     "sum")


def _box_mean2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Box mean with zero-extended edges: the box sum over the per-cell
    count of in-bounds cells."""
    R, D = x.shape[-2:]
    pad = size // 2

    def counts(n):
        i = torch.arange(n, device=x.device)
        return (torch.clamp(i + pad, max=n - 1) - torch.clamp(i - pad, min=0)
                + 1.0)

    return _box_sum2d(x, size) / (counts(R)[:, None] * counts(D)[None, :])


_OS_CHUNK = 128       # frames per order-statistic sort in _os_noise


def _os_noise(p_lin: torch.Tensor, train: int, guard: int,
              rank: float) -> torch.Tensor:
    """Order-statistic noise estimate per cell of power maps [F, R, D].

    The training cells of a cell are a cross of ``train`` cells per side
    beyond the guard band along both axes (4 train samples); the estimate
    is the ``rank``-quantile of those inside the map.  The reference rolls
    the map and masks wrapped samples to +inf; padding the map with +inf
    and slicing gives the same samples.  k = round(rank (n_valid - 1)) is
    taken in float32 with round-half-to-even, as ``jnp.round``.  A cell
    with no valid sample (tiny maps) falls back to the mean of its own
    frame's map.  Frames are sorted ``_OS_CHUNK`` at a time: the stack is
    4 train floats per cell (~3.4 GB at 2048 frames of 400 x 32), and the
    sort needs as much again plus its indices.

    Counters, on the host at each call: ``.calls``, ``.chunks`` (the
    sorts) and ``.samples`` (cells x 4 train)."""
    F, R, D = p_lin.shape
    dev = p_lin.device
    _os_noise.calls += 1
    _os_noise.chunks += -(-F // _OS_CHUNK)
    _os_noise.samples += F * R * D * 4 * train
    h = guard + train
    offs = range(guard + 1, h + 1)
    row = torch.arange(R, device=dev)[:, None]
    col = torch.arange(D, device=dev)[None, :]
    n_valid = sum(((row >= o).to(torch.int32) + (row < R - o).to(torch.int32)
                   + (col >= o).to(torch.int32) + (col < D - o).to(torch.int32))
                  for o in offs)                                  # [R, D]
    k = torch.clamp(torch.round(rank * (n_valid - 1).to(torch.float32))
                    .to(torch.int64), 0, 4 * train - 1)
    out = torch.empty_like(p_lin)
    for i in range(0, F, _OS_CHUNK):
        p = p_lin[i:i + _OS_CHUNK]
        xp = tfn.pad(p, (h, h, h, h), value=float("inf"))
        # The reference's stack order (+o, -o along range, +o, -o along
        # Doppler); the sort makes it immaterial.
        shifts = []
        for o in offs:
            shifts += [xp[:, h - o:h - o + R, h:h + D],
                       xp[:, h + o:h + o + R, h:h + D],
                       xp[:, h:h + R, h - o:h - o + D],
                       xp[:, h:h + R, h + o:h + o + D]]
        stack = torch.sort(torch.stack(shifts, dim=-1), dim=-1).values
        est = torch.gather(stack, -1,
                           k.expand(p.shape[0], R, D)[..., None])[..., 0]
        mean = torch.mean(p, dim=(-2, -1), keepdim=True)
        out[i:i + _OS_CHUNK] = torch.where(torch.isfinite(est), est, mean)
    return out


_os_noise.calls = 0
_os_noise.chunks = 0
_os_noise.samples = 0


def os_chunks(frames: int, det: DetectionConfig) -> int:
    """The order statistic's sorts over ``frames`` maps at ``det``: one
    per ``_OS_CHUNK`` frames with OS-CFAR and training cells, else 0."""
    if det.cfar_mode != "os" or det.cfar_train_cells <= 0:
        return 0
    return -(-frames // _OS_CHUNK)


def power_spectrum_db(rds: torch.Tensor) -> torch.Tensor:
    """Non-coherent power map [..., R, D] in dB of an RDS [..., A, R, D]."""
    return db10(torch.mean(rds.abs() ** 2, dim=-3) + 1e-12)


def _threshold_power(p_lin: torch.Tensor, det: DetectionConfig):
    """Local max + (CA-CFAR-relative) threshold of a linear power map
    [F, R, D].  Returns (power_db, is_peak_above)."""
    power_db = db10(p_lin)
    is_peak = _maxpool2d_same(power_db, det.neighborhood) == power_db
    return power_db, is_peak & (power_db > threshold_db(p_lin, det))


def threshold_db(p_lin: torch.Tensor, det: DetectionConfig):
    """The detection threshold (dB) of a linear power map [F, R, D]: the
    CFAR noise estimate plus its offset, floored at ``threshold_db`` (a
    map [F, R, D]), or the floor alone without training cells."""
    if det.cfar_train_cells > 0:
        if det.cfar_mode == "os":
            noise = _os_noise(p_lin, det.cfar_train_cells, det.guard_cells,
                              det.os_rank)
        elif det.cfar_mode == "ca":
            train = 2 * det.cfar_train_cells + 2 * det.guard_cells + 1
            guard = 2 * det.guard_cells + 1
            noise = _box_mean2d(p_lin, train)
            if det.guard_cells > 0:
                g = _box_mean2d(p_lin, guard)
                n_train = train * train
                n_guard = guard * guard
                noise = (noise * n_train - g * n_guard) / (n_train - n_guard)
        else:
            raise ValueError(f"Unknown cfar_mode: {det.cfar_mode}")
        noise_db = db10(torch.clamp(noise, min=1e-12))
        return torch.clamp(noise_db + det.cfar_offset_db,
                           min=det.threshold_db)
    return det.threshold_db


def clutter_map_update(clutter_lin: torch.Tensor, rds: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """One EMA step of the background power map [F, R, D] (linear) from an
    RDS [F, A, R, D]: persistent returns build up in the map and are gated
    out, transient ones are not.  The map starts at zero (no effect)."""
    p = torch.mean(rds.abs() ** 2, dim=-3)
    return clutter_map_update_from_power(clutter_lin, p, alpha)


def clutter_map_update_from_power(clutter_lin: torch.Tensor,
                                  p_lin: torch.Tensor,
                                  alpha: float) -> torch.Tensor:
    """:func:`clutter_map_update` from a linear power map [F, R, D]."""
    return (1.0 - alpha) * clutter_lin + alpha * p_lin


def detect_peaks(rds: torch.Tensor, cfg: RadarConfig, det: DetectionConfig,
                 use_pallas: bool = False,
                 clutter_lin: Optional[torch.Tensor] = None) -> Detections:
    """Top-K range-Doppler peaks [F, K] of an RDS [F, A, R, D], sorted by
    descending power.  ``use_pallas`` routes power / local max / CA-CFAR
    through the CFAR-mask kernel (``ops/cfar.py``: CUDA on a CUDA tensor,
    its plain version on a CPU tensor).  That kernel implements CA only, so
    with ``cfar_mode="os"`` the plain detector runs and no kernel launches,
    as the reference routes it (its detect.py:150-151).  ``clutter_lin``
    [F, R, D] is the optional background power map; the clutter gate
    follows the kernel as it follows the plain detector."""
    if use_pallas and det.cfar_mode == "ca":
        from radar_slam_tpu_torch.ops.cfar import cfar_mask
        power_db, is_peak_above = cfar_mask(
            rds, threshold_db=det.threshold_db,
            neighborhood=det.neighborhood, train=det.cfar_train_cells,
            guard=det.guard_cells, offset_db=det.cfar_offset_db)
    else:
        p_lin = torch.mean(rds.abs() ** 2, dim=-3) + 1e-12
        power_db, is_peak_above = _threshold_power(p_lin, det)
    return _finalize_detections(power_db, is_peak_above, cfg, det,
                                clutter_lin)


def detect_peaks_from_power(p_lin: torch.Tensor, cfg: RadarConfig,
                            det: DetectionConfig,
                            clutter_lin: Optional[torch.Tensor] = None
                            ) -> Detections:
    """:func:`detect_peaks` from a linear power map [F, R, D]
    (``mean_a |rds|^2``, the fused path's input)."""
    power_db, is_peak_above = _threshold_power(p_lin + 1e-12, det)
    return _finalize_detections(power_db, is_peak_above, cfg, det,
                                clutter_lin)


def _finalize_detections(power_db: torch.Tensor, is_peak_above: torch.Tensor,
                         cfg: RadarConfig, det: DetectionConfig,
                         clutter_lin: Optional[torch.Tensor] = None
                         ) -> Detections:
    """Range gate, clutter gate (``power_db`` above ``10 log10`` of the
    background map plus ``clutter_offset_db``), exact top-K over the masked
    map (flat index r*D + d), then :func:`_detections_from_bins`."""
    F, R, D = power_db.shape
    lo, hi = range_gate_bin_interval(cfg, R, det)
    r_idx = torch.arange(R, device=power_db.device)
    gate = (r_idx >= lo) & (r_idx <= hi)
    mask = is_peak_above & gate[:, None]
    if clutter_lin is not None:
        if clutter_lin.shape[-2:] != (R, D):
            raise ValueError(f"clutter_lin: need [..., {R}, {D}], got "
                             f"{tuple(clutter_lin.shape)}")
        clutter_db = 10.0 * torch.log10(torch.clamp(clutter_lin, min=1e-12))
        mask = mask & (power_db > clutter_db + det.clutter_offset_db)
    score = torch.where(mask, power_db, -float("inf")).reshape(F, R * D)
    top_vals, top_idx = topk_exact(score, det.max_detections)
    return _detections_from_bins(power_db, top_idx // D, top_idx % D,
                                 top_vals, cfg, det)


def extract_spatial_signatures(rds: torch.Tensor,
                               detections: Detections) -> torch.Tensor:
    """Unit-power spatial signatures [F, K, A]: ``rds[f, :, r_k, d_k]``
    normalized (an invalid slot gathers cell (0, 0), as in the
    reference)."""
    F, A, R, D = rds.shape
    flat = (detections.range_bin.to(torch.int64) * D
            + detections.doppler_bin.to(torch.int64))             # [F, K]
    idx = flat[:, None, :].expand(F, A, flat.shape[-1])
    sig = torch.gather(rds.reshape(F, A, R * D), 2, idx).transpose(1, 2)
    power = torch.sum(sig.abs() ** 2, dim=-1, keepdim=True)
    return torch.where(power > 0,
                       sig / torch.sqrt(torch.clamp(power, min=1e-30)), sig)


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
