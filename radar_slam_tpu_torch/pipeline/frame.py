"""The pipelines: scatterers or ADC cubes in, poses out.

Counterpart of ``radar_slam_tpu/pipeline/frame.py``: its batched, chunked
and sequential drivers and their one-frame steps.  The scatterer front end
routes as a TPU routes it (the reference's frame.py:219-221, :653-657 and
:781-793), with no backend test:

- **one-pass** at ``fft_mode="fused"`` with ``synth_in_kernel``,
  ``frontend_one_pass`` and CA-CFAR: synthesis factors (split, or dense with
  ``frontend_factors="dense"``) -> the front-end kernel (K1, or K3; with
  the clutter map as its clutter input) -> exact top-K + Z-column
  signatures -> detections -- the path of ``complete_analysis_config()``;
- **three-dispatch** at ``fft_mode="fused"`` with ``synth_in_kernel``
  otherwise (OS-CFAR, or ``frontend_one_pass=False``): dense factors ->
  power map from the factors (K4) -> detection -> signatures from the
  factors (K5);
- **materialized** otherwise: the ADC cubes are synthesized and go through
  the cube front end (:func:`_cube_front_end`: the fused power map, K7, or
  the complex RDS of ``"fft"``, ``"matmul"``, ``"pallas"``, with K8 / K9 /
  K10 as the config selects).

Every driver draws its per-frame noise seeds with ``frame_seeds(generator,
F)`` (``ops/noise.py``; element (a*C + c) * S + s of the noise plane), so
for one generator state all drivers and all three routes see the same
noisy frames.

- Batched: :func:`process_sequence_batched` (scatterers) and
  :func:`process_signal_sequence_batched` (cubes).  Phase A over all
  frames at once; phase B windowed temporal smoothing, mutual-NN
  association with the previous frame, the batched 6-DoF solve without the
  temporal prior, a prefix-sum pose.
- Sequential: :func:`process_scatterers` / :func:`process_signals`, one
  frame and a :class:`FrameState` in, the next state out (slot-table
  smoother, previous targets and motion, pose, the clutter map), driven by
  :func:`process_sequence` / :func:`process_signal_sequence` as Python
  loops over frames.
- Chunked: :func:`process_sequence_chunked`, the sequential semantics with
  the front end batched over windows of frames and the prior chain exact
  or relaxed to two batched sweeps (``prior="jacobi"``).

The device of the input tensors decides whether a kernel launches its CUDA
code (``cuda``) or runs its plain PyTorch version (``cpu``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.aoa import confidence as conf_mod
from radar_slam_tpu_torch.aoa import estimators, smoothing
from radar_slam_tpu_torch.aoa.robust import process_targets_robust
from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.types import (Associations, Detections,
                                             FrameOutput, MotionEstimate,
                                             ScattererBatch, Targets)
from radar_slam_tpu_torch.motion.associate import associate_targets
from radar_slam_tpu_torch.motion.pose import planar_pose_step
from radar_slam_tpu_torch.motion.velocity import solve_velocity
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops import synthpower as sp
from radar_slam_tpu_torch.ops.noise import frame_seeds
from radar_slam_tpu_torch.ops.windows import window_freq_taps
from radar_slam_tpu_torch.signal import detect as detect_mod
from radar_slam_tpu_torch.signal.rds import (_mix_vector,
                                             detection_signatures,
                                             range_doppler_spectrum,
                                             rds_power)
from radar_slam_tpu_torch.signal.synth import (fast_time_base,
                                               synthesis_factors,
                                               synthesis_factors_split,
                                               synthesize_frame,
                                               synthesize_frames_batch)
from radar_slam_tpu_torch.utils.host import tree_map as _map


def _check_common(cfg: PipelineConfig) -> None:
    if cfg.detection.cfar_mode not in ("ca", "os"):
        raise ValueError(f"Unknown cfar_mode: {cfg.detection.cfar_mode}")
    if cfg.chirp_subset is not None:
        raise NotImplementedError("chirp_subset is not ported")
    if cfg.radar.num_antennas_el != 1:
        raise NotImplementedError(
            "num_antennas_el > 1 (a 2-D array) is not ported (ROADMAP: "
            "URA arrays and elevation)")


def _no_clutter_map(cfg: PipelineConfig, driver: str) -> None:
    """The reference's rule for its chunked driver
    (``process_sequence_chunked``): the clutter EMA feeds detection, which
    makes the front end sequential.  Its batched drivers ignore the map
    (they never read ``clutter_map_alpha``), and so do the port's."""
    if cfg.detection.clutter_map_alpha > 0:
        raise ValueError(f"{driver} requires clutter_map_alpha == 0 (the "
                         "clutter EMA makes detection sequential); use "
                         "process_sequence")


def _check_cube_supported(cfg: PipelineConfig) -> None:
    """The cube-input path: every fft_mode ("fused", "fft", "matmul",
    "pallas") with or without ``use_pallas``, CA- or OS-CFAR, a 1-D
    array."""
    _check_common(cfg)
    if cfg.fft_mode not in ("fused", "fft", "matmul", "pallas"):
        raise ValueError(f"Unknown fft_mode: {cfg.fft_mode}")


def _phase_a_route(cfg: PipelineConfig) -> str:
    """The scatterer driver's phase A, routed as a TPU routes it with no
    backend test: "one_pass", "three_dispatch" or "materialized" (see the
    module docstring)."""
    if cfg.fft_mode == "fused" and cfg.synth_in_kernel:
        if cfg.frontend_one_pass and cfg.detection.cfar_mode == "ca":
            return "one_pass"
        return "three_dispatch"
    return "materialized"


def _check_supported(cfg: PipelineConfig) -> None:
    """The scatterer driver's configs; a config that selects an unported
    path raises instead of silently running another (the one-pass front
    end's K1' knobs raise in ``ops/frontend.py``)."""
    route = _phase_a_route(cfg)
    if route == "materialized":
        _check_cube_supported(cfg)
        return
    if route == "one_pass" and cfg.frontend_factors not in ("split",
                                                            "dense"):
        raise ValueError(f"Unknown frontend_factors: {cfg.frontend_factors}")
    _check_common(cfg)


def _onepass_frontend(scatterers: ScattererBatch, seeds: torch.Tensor,
                      cfg: PipelineConfig,
                      clutter: Optional[torch.Tensor] = None):
    """Front end over a frame batch: synthesis factors (split, or dense
    with ``frontend_factors="dense"``) -> kernel (K1, or K3; ``clutter``
    [F, R, D] its clutter input) -> exact top-K + signatures ->
    detections.  Returns (p_lin [F, R, D], Detections [F, K], sigs
    [F, K, A])."""
    C = cfg.radar.num_chirps
    S = cfg.radar.samples_per_chirp
    sigma = float(cfg.radar.noise_power) ** 0.5
    d = cfg.detection
    dev = scatterers.range_m.device
    mix = _mix_vector(cfg.radar, cfg.window, "baseband", S, device=dev)
    lo, hi = detect_mod.range_gate_bin_interval(cfg.radar, S, d)
    common = dict(
        train=d.cfar_train_cells, guard=d.guard_cells,
        neighborhood=d.neighborhood, offset_db=d.cfar_offset_db,
        threshold_db=d.threshold_db, min_range_bin=lo, max_range_bin=hi,
        clutter=clutter, clutter_offset_db=d.clutter_offset_db,
        doppler_window=cfg.doppler_window, noise_impl=cfg.noise_impl,
        noise_domain=cfg.noise_domain,
        noise_taps=window_freq_taps(cfg.window),
        doppler_precision=cfg.synth_doppler_precision,
        doppler_layout=cfg.synth_doppler_layout,
        topk_mode=cfg.frontend_topk)
    if cfg.frontend_factors == "split":
        split = synthesis_factors_split(scatterers, cfg.radar,
                                        cfg.synth_fidelity)
        t = fast_time_base(cfg.radar, cfg.synth_fidelity, device=dev)
        echo_upper = (cfg.radar.chirp_duration
                      if cfg.synth_fidelity == "reference" else None)
        p_lin, rb, db, vals, sigs = fe.scatterer_frontend_split(
            split.ant, split.dopp, split.coarse, split.fine, split.tau, t,
            seeds, mix, C, sigma, d.max_detections, echo_upper=echo_upper,
            **common)
    else:
        e_ac, e_fast = synthesis_factors(scatterers, cfg.radar,
                                         cfg.synth_fidelity)
        p_lin, rb, db, vals, sigs = fe.scatterer_frontend(
            e_ac, e_fast, seeds, mix, C, sigma, d.max_detections,
            precision_name=cfg.power_precision, **common)
    det = detect_mod.detections_from_topk(p_lin, rb, db, vals, cfg.radar,
                                          cfg.detection)
    return p_lin, det, sigs


def _three_dispatch_frontend(scatterers: ScattererBatch,
                             seeds: torch.Tensor, cfg: PipelineConfig,
                             clutter: Optional[torch.Tensor] = None):
    """The power map straight from the dense synthesis factors (K4),
    detection on it (CA- or OS-CFAR, ``clutter`` [F, R, D] gating), then
    the detected cells' signatures from the factors with the same noise
    (K5).  Returns (p_lin, Detections, sigs) as :func:`_onepass_frontend`."""
    C = cfg.radar.num_chirps
    S = cfg.radar.samples_per_chirp
    sigma = float(cfg.radar.noise_power) ** 0.5
    mix = _mix_vector(cfg.radar, cfg.window, "baseband", S,
                      device=scatterers.range_m.device)
    e_ac, e_fast = synthesis_factors(scatterers, cfg.radar,
                                     cfg.synth_fidelity)
    p_lin = sp.scatterer_power(e_ac, e_fast, seeds, mix, C, sigma,
                               doppler_window=cfg.doppler_window,
                               precision_name=cfg.power_precision,
                               doppler_precision=cfg.synth_doppler_precision,
                               doppler_layout=cfg.synth_doppler_layout,
                               noise_impl=cfg.noise_impl)
    det = detect_mod.detect_peaks_from_power(p_lin, cfg.radar, cfg.detection,
                                             clutter_lin=clutter)
    sigs = sp.scatterer_signatures(e_ac, e_fast, seeds, det.range_bin,
                                   det.doppler_bin, mix, C, sigma,
                                   doppler_window=cfg.doppler_window,
                                   noise_impl=cfg.noise_impl)
    return p_lin, det, sigs


def _cube_front_end(signals: torch.Tensor, cfg: PipelineConfig,
                    clutter: Optional[torch.Tensor] = None):
    """Detection and signatures of ADC cubes [F, A, C, S].

    ``fft_mode="fused"`` takes the power map straight from the cubes
    (``rds_power``: the K7 kernel on a CUDA tensor) and recomputes only the
    detected cells' signatures; the other modes build the complex RDS
    (``"pallas"``: the K8 kernel; ``"fft"`` with ``use_pallas``: the K9
    kernel) and detect on it (with ``use_pallas``: the K10 kernel).
    ``clutter`` [F, R, D] gates the detections.  Returns (p_lin, det,
    sigs); p_lin (``mean_a |rds|^2``, what the clutter map averages) is
    None for the RDS modes unless ``clutter`` is given."""
    if cfg.fft_mode == "fused":
        p_lin = rds_power(signals, cfg.radar, window=cfg.window,
                          chirp_subset=cfg.chirp_subset,
                          doppler_window=cfg.doppler_window,
                          dft_precision=cfg.power_precision,
                          doppler_precision=cfg.doppler_precision,
                          doppler_layout=cfg.doppler_layout)
        det = detect_mod.detect_peaks_from_power(p_lin, cfg.radar,
                                                 cfg.detection,
                                                 clutter_lin=clutter)
        sigs = detection_signatures(signals, det.range_bin, det.doppler_bin,
                                    cfg.radar, window=cfg.window,
                                    chirp_subset=cfg.chirp_subset,
                                    doppler_window=cfg.doppler_window)
        return p_lin, det, sigs
    rds = range_doppler_spectrum(signals, cfg.radar, window=cfg.window,
                                 chirp_subset=cfg.chirp_subset,
                                 doppler_window=cfg.doppler_window,
                                 use_pallas=cfg.use_pallas,
                                 fft_mode=cfg.fft_mode,
                                 dft_precision=cfg.dft_precision)
    det = detect_mod.detect_peaks(rds, cfg.radar, cfg.detection,
                                  use_pallas=cfg.use_pallas,
                                  clutter_lin=clutter)
    sigs = detect_mod.extract_spatial_signatures(rds, det)
    p_lin = (torch.mean(rds.abs() ** 2, dim=-3) if clutter is not None
             else None)
    return p_lin, det, sigs


def _scatterer_front_end(scatterers: ScattererBatch, seeds: torch.Tensor,
                         cfg: PipelineConfig,
                         clutter: Optional[torch.Tensor] = None):
    """The scatterer front end on its route (module docstring) for frames
    [F, S_max] and their seeds [F].  Returns (p_lin, det, sigs)."""
    route = _phase_a_route(cfg)
    if route == "one_pass":
        return _onepass_frontend(scatterers, seeds, cfg, clutter)
    if route == "three_dispatch":
        return _three_dispatch_frontend(scatterers, seeds, cfg, clutter)
    signals = synthesize_frame(scatterers, cfg.radar, seeds,
                               fidelity=cfg.synth_fidelity)
    return _cube_front_end(signals, cfg, clutter)


def sequence_features_scatterers_fused(scatterers: ScattererBatch,
                                       generator: torch.Generator,
                                       cfg: PipelineConfig):
    """Phase A for scatterers [F, S_max] without a cube through torch: the
    one-pass or the three-dispatch front end (see :func:`_phase_a_route`),
    seeded from ``generator`` as every driver is.  Returns the AoA features
    with the frame axis."""
    if cfg.chirp_subset is not None:
        raise ValueError("synth_in_kernel requires chirp_subset=None")
    F = scatterers.range_m.shape[0]
    seeds = frame_seeds(generator, F, scatterers.range_m.device)
    _, det, sigs = _scatterer_front_end(scatterers, seeds, cfg)
    return _aoa_features(det, sigs, cfg)


def _aoa_features(det: Detections, sigs: torch.Tensor, cfg: PipelineConfig):
    """MDL model order, angles and confidence for every frame's detections
    [F, K].  Returns (det, sigs, keep, num_sources, is_multi, angles_deg,
    el_deg, conf)."""
    K = det.range_bin.shape[-1]
    keep = (det.valid & (det.power_db > cfg.aoa.power_filter_db)
            & (torch.arange(K, device=sigs.device) < cfg.aoa.max_targets))
    eigvals = estimators.rank1_eigenvalues(sigs)
    num_sources, is_multi, _ = conf_mod.mdl_model_order(eigvals)
    angles_deg, el_deg, _ = estimators.estimate_angles_2d(
        sigs, cfg.radar, cfg.aoa, method=cfg.aoa.method,
        num_sources=num_sources)
    conf = conf_mod.angle_confidence(sigs, angles_deg, cfg.radar, el_deg)
    return det, sigs, keep, num_sources, is_multi, angles_deg, el_deg, conf


def _batched_assoc_solve(targets: Targets, cfg: PipelineConfig,
                         sensor_pos: Optional[torch.Tensor] = None,
                         group: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, MotionEstimate]:
    """Association with the previous frame (a shift, not a scan) and the
    velocity solve, batched over frames; no temporal prior.
    ``sensor_pos`` [K, 3] and ``group`` [K] are the mounted rig's
    per-target sensor origins and sensor-block ids
    (``pipeline/rig.py``)."""
    F = targets.range_m.shape[0]
    prev = Targets(*[None if x is None else torch.cat([x[:1], x[:-1]])
                     for x in targets])
    assoc = associate_targets(targets, prev, cfg.frame_dt, cfg.velocity,
                              sensor_pos=sensor_pos, group=group)
    has_prev = torch.arange(F, device=targets.range_m.device) > 0
    assoc = assoc._replace(valid=assoc.valid & has_prev[:, None])
    motion = solve_velocity(
        assoc, cfg.frame_dt, cfg.radar.lambda_c, cfg.velocity,
        v_unambiguous=cfg.radar.max_unambiguous_velocity)
    return assoc.num_valid, motion


def _pose_prefix(motion: MotionEstimate, cfg: PipelineConfig,
                 rotate_pose: bool) -> torch.Tensor:
    """Planar pose [F, 3] as prefix sums over per-frame increments."""
    dtf = float(np.float32(cfg.frame_dt))
    wz = torch.where(motion.success, motion.angular_velocity[:, 2], 0.0)
    yaw_after = torch.cumsum(wz * dtf, dim=0)
    yaw_before = yaw_after - wz * dtf
    v = torch.where(motion.success[:, None], motion.velocity[:, :2], 0.0)
    if rotate_pose:
        c, s = torch.cos(yaw_before), torch.sin(yaw_before)
        step_xy = torch.stack([c * v[:, 0] - s * v[:, 1],
                               s * v[:, 0] + c * v[:, 1]], dim=-1) * dtf
    else:
        step_xy = v * dtf
    xy_after = torch.cumsum(step_xy, dim=0)
    return torch.cat([xy_after, yaw_after[:, None]], dim=-1)


def _smoothed_targets(features, angles_s: torch.Tensor,
                      conf_s: torch.Tensor, cfg: PipelineConfig) -> Targets:
    """The targets of the AoA features after temporal smoothing (smoothed
    angles ``angles_s`` [deg] and confidences ``conf_s``), reliable where
    kept, confident and single-source."""
    (det, sigs, keep, num_sources, is_multi, _, el_deg, _) = features
    reliable = keep & (conf_s >= cfg.aoa.confidence_threshold) & ~is_multi
    return Targets(
        range_bin=det.range_bin, doppler_bin=det.doppler_bin,
        range_m=det.range_m, doppler_hz=det.doppler_hz,
        vr_mps=det.vr_mps, power_db=det.power_db,
        azimuth_rad=torch.deg2rad(angles_s), confidence=conf_s,
        num_sources=num_sources, is_multipath=is_multi,
        is_reliable=reliable, spatial_signature=sigs, valid=keep,
        elevation_rad=torch.deg2rad(el_deg))


def _sequence_from_features(features, cfg: PipelineConfig,
                            rotate_pose: bool) -> FrameOutput:
    """Phase B: windowed temporal smoothing, shift-association, batched
    solves, prefix-sum pose."""
    det, _, keep, _, _, angles_deg, _, conf = features
    D = cfg.radar.num_chirps
    det_keys = det.range_bin * D + det.doppler_bin                # [F, K]
    angles_s, conf_s = smoothing.smooth_windowed(
        det_keys, angles_deg, conf, keep, cfg.aoa)

    targets = _smoothed_targets(features, angles_s, conf_s, cfg)
    n_assoc, motion = _batched_assoc_solve(targets, cfg)
    pose = _pose_prefix(motion, cfg, rotate_pose)
    return FrameOutput(
        motion=motion, pose=pose,
        num_detections=torch.sum(det.valid, dim=-1).to(torch.int32),
        num_reliable=torch.sum(targets.is_reliable,
                               dim=-1).to(torch.int32),
        num_associations=n_assoc.to(torch.int32),
        target_xy=targets.position[..., :2],
        target_valid=targets.valid & targets.is_reliable)


def frame_features(signals: torch.Tensor, cfg: PipelineConfig):
    """Phase A of the cube-input path over ADC cubes [F, A, C, S]:
    :func:`_cube_front_end`, then the AoA tail.  Returns (det, sigs, keep,
    num_sources, is_multi, angles_deg, el_deg, conf), each with the leading
    frame axis."""
    _, det, sigs = _cube_front_end(signals, cfg)
    return _aoa_features(det, sigs, cfg)


def process_sequence_batched(scatterers: ScattererBatch,
                             generator: torch.Generator,
                             cfg: PipelineConfig,
                             rotate_pose: bool = True) -> FrameOutput:
    """Throughput-oriented whole-sequence pipeline over scatterers [F, S_max].

    ``generator`` draws the per-frame noise seeds (the only randomness);
    the same generator state gives the same noise on either device type,
    and on the three-dispatch and the materialized paths.  Phase A is
    :func:`sequence_features_scatterers_fused` (one-pass or three-dispatch)
    at ``fft_mode="fused"`` with ``synth_in_kernel``; otherwise the ADC
    cubes are synthesized (``synthesize_frames_batch``) and go through
    :func:`frame_features`.  Returns a :class:`FrameOutput` with leading
    frame axis [F]."""
    _check_supported(cfg)
    fe.use_f32_matmuls()
    if _phase_a_route(cfg) != "materialized":
        features = sequence_features_scatterers_fused(scatterers, generator,
                                                      cfg)
    else:
        signals = synthesize_frames_batch(scatterers, cfg.radar, generator,
                                          fidelity=cfg.synth_fidelity)
        features = frame_features(signals, cfg)
    return _sequence_from_features(features, cfg, rotate_pose)


def process_signal_sequence_batched(signals: torch.Tensor,
                                    cfg: PipelineConfig,
                                    rotate_pose: bool = True) -> FrameOutput:
    """Batched (two-phase) driver over ADC cubes [F, A, C, S] complex64
    (baseband): :func:`frame_features` over all frames, then phase B.
    Returns a :class:`FrameOutput` with leading frame axis [F]."""
    _check_cube_supported(cfg)
    _check_signals(signals, cfg)
    fe.use_f32_matmuls()
    features = frame_features(signals, cfg)
    return _sequence_from_features(features, cfg, rotate_pose)


def _check_signals(signals: torch.Tensor, cfg: PipelineConfig) -> None:
    r = cfg.radar
    want = (r.num_antennas, r.num_chirps, r.samples_per_chirp)
    if signals.dim() != 4 or tuple(signals.shape[1:]) != want:
        raise ValueError(f"signals: need [F, {want[0]}, {want[1]}, "
                         f"{want[2]}], got {tuple(signals.shape)}")
    if signals.dtype != torch.complex64:
        raise TypeError(f"signals: dtype {signals.dtype} != complex64")


# ---- the sequential drivers ------------------------------------------------

class FrameState(NamedTuple):
    """What the sequential drivers carry from one frame to the next.  The
    per-frame fields keep a leading frame axis of 1, so that the batched
    stages take them as they are."""

    smoother: smoothing.SmootherState
    prev_targets: Targets        # [1, K]
    prev_valid: torch.Tensor     # [1] bool
    prev_motion: torch.Tensor    # [1, 6]
    pose: torch.Tensor           # [1, 3] planar (x, y, yaw)
    # EMA background power map [1, R, D]; present only when
    # cfg.detection.clutter_map_alpha > 0.
    clutter: Optional[torch.Tensor] = None


def _empty_targets(cfg: PipelineConfig, device) -> Targets:
    K = cfg.detection.max_detections
    A = cfg.radar.total_antennas
    zf = torch.zeros((1, K), dtype=torch.float32, device=device)
    zi = torch.zeros((1, K), dtype=torch.int32, device=device)
    zb = torch.zeros((1, K), dtype=torch.bool, device=device)
    return Targets(range_bin=zi, doppler_bin=zi, range_m=zf, doppler_hz=zf,
                   vr_mps=zf, power_db=zf, azimuth_rad=zf, confidence=zf,
                   num_sources=zi, is_multipath=zb, is_reliable=zb,
                   spatial_signature=torch.zeros((1, K, A),
                                                 dtype=torch.complex64,
                                                 device=device),
                   valid=zb, elevation_rad=zf)


def _clutter_shape(cfg: PipelineConfig) -> Tuple[int, int]:
    R = cfg.radar.samples_per_chirp
    D = (cfg.radar.num_chirps if cfg.chirp_subset is None
         else cfg.chirp_subset[1] - cfg.chirp_subset[0])
    return (R, D)


def init_state(cfg: PipelineConfig, initial_pose=None,
               device=DEFAULT) -> FrameState:
    """The state before the first frame, on ``device`` (the card unless the
    caller names another): an empty smoother table, no previous targets,
    zero motion, the initial pose ([3], default 0), and a zero clutter map
    when ``clutter_map_alpha > 0``."""
    device = resolve(device)
    pose = torch.zeros((1, 3), dtype=torch.float32, device=device)
    if initial_pose is not None:
        pose = torch.as_tensor(initial_pose, dtype=torch.float32,
                               device=device).reshape(1, 3)
    return FrameState(
        smoother=smoothing.init_state(cfg.aoa, device),
        prev_targets=_empty_targets(cfg, device),
        prev_valid=torch.zeros(1, dtype=torch.bool, device=device),
        prev_motion=torch.zeros((1, 6), dtype=torch.float32, device=device),
        pose=pose,
        clutter=(torch.zeros((1,) + _clutter_shape(cfg),
                             dtype=torch.float32, device=device)
                 if cfg.detection.clutter_map_alpha > 0 else None))


def frame_state_from_numpy(fields: Dict[str, object], device) -> FrameState:
    """A :class:`FrameState` on ``device`` from the reference's state read
    back as numpy: ``smoother`` (a mapping of the ``SmootherState`` fields),
    ``prev_targets`` (a mapping of the ``Targets`` fields, [K]),
    ``prev_valid`` (scalar), ``prev_motion`` [6], ``pose`` [3] and
    ``clutter`` ([R, D] or None).  The per-frame fields get the leading
    frame axis of 1; integers become int32, complex values complex64."""

    def tensor(x, batch: bool):
        a = np.asarray(x)
        if a.dtype.kind in "iu":
            a = a.astype(np.int32)
        elif a.dtype.kind == "c":
            a = a.astype(np.complex64)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        a = np.array(a[None] if batch else a, order="C")
        return torch.from_numpy(a).to(device)

    sm = fields["smoother"]
    tg = fields["prev_targets"]
    clutter = fields.get("clutter")
    return FrameState(
        smoother=smoothing.SmootherState(
            *[tensor(sm[n], False) for n in smoothing.SmootherState._fields]),
        prev_targets=Targets(*[None if tg.get(n) is None
                               else tensor(tg[n], True)
                               for n in Targets._fields]),
        prev_valid=tensor(np.asarray(fields["prev_valid"], dtype=bool),
                          True),
        prev_motion=tensor(fields["prev_motion"], True),
        pose=tensor(fields["pose"], True),
        clutter=None if clutter is None else tensor(clutter, True))


def _solve_and_step(assoc: Associations, prev_motion: torch.Tensor,
                    pose: torch.Tensor, cfg: PipelineConfig,
                    rotate_pose: bool):
    """One frame's 6-DoF solve with ``prev_motion`` [1, 6] as its prior
    (and fallback), and the pose [1, 3] it moves.  Returns the motion, the
    new pose and the prior for the next frame (the params of a success,
    else the old prior)."""
    motion = solve_velocity(assoc, cfg.frame_dt, cfg.radar.lambda_c,
                            cfg.velocity, prev_motion=prev_motion,
                            v_unambiguous=cfg.radar.max_unambiguous_velocity)
    # A failed solve already returns the previous motion, so coasting
    # dead-reckons through gaps; without coast_on_failure the pose freezes.
    stepped = planar_pose_step(pose, motion.velocity,
                               motion.angular_velocity[:, 2],
                               float(np.float32(cfg.frame_dt)), rotate_pose)
    ok = motion.success[:, None]
    return (motion,
            stepped if cfg.pose.coast_on_failure
            else torch.where(ok, stepped, pose),
            torch.where(ok, motion.params, prev_motion))


def _step_from_targets(state: FrameState, det: Detections, targets: Targets,
                       smoother: smoothing.SmootherState, clutter,
                       cfg: PipelineConfig, rotate_pose: bool
                       ) -> Tuple[FrameState, FrameOutput]:
    """The stateful tail of one frame step: association with the previous
    targets, the 6-DoF solve with the previous motion as its prior (and
    fallback), the pose update, the next state."""
    assoc = associate_targets(targets, state.prev_targets, cfg.frame_dt,
                              cfg.velocity)
    assoc = assoc._replace(valid=assoc.valid & state.prev_valid[:, None])
    motion, pose, prev_motion = _solve_and_step(
        assoc, state.prev_motion, state.pose, cfg, rotate_pose)
    new_state = FrameState(
        smoother=smoother, prev_targets=targets,
        prev_valid=torch.sum(targets.valid, dim=-1) > 0,
        prev_motion=prev_motion, pose=pose, clutter=clutter)
    out = FrameOutput(
        motion=motion, pose=pose,
        num_detections=torch.sum(det.valid, dim=-1).to(torch.int32),
        num_reliable=torch.sum(targets.is_reliable, dim=-1).to(torch.int32),
        num_associations=assoc.num_valid.to(torch.int32),
        target_xy=targets.position[..., :2],
        target_valid=targets.valid & targets.is_reliable)
    return new_state, out


def _step_from_front_end(state: FrameState, p_lin, det: Detections,
                         sigs: torch.Tensor, cfg: PipelineConfig,
                         rotate_pose: bool
                         ) -> Tuple[FrameState, FrameOutput]:
    """The clutter-map update, the robust AoA stage (slot-table smoother)
    and :func:`_step_from_targets` after one frame's front end."""
    clutter = (detect_mod.clutter_map_update_from_power(
        state.clutter, p_lin, cfg.detection.clutter_map_alpha)
        if state.clutter is not None else None)
    targets, smoother = process_targets_robust(
        None, det, state.smoother, cfg.radar, cfg.aoa,
        method=cfg.aoa.method, signatures=sigs,
        doppler_bins=_clutter_shape(cfg)[1])
    return _step_from_targets(state, det, targets, smoother, clutter, cfg,
                              rotate_pose)


def process_signals(state: FrameState, signals: torch.Tensor,
                    cfg: PipelineConfig, rotate_pose: bool = True
                    ) -> Tuple[FrameState, FrameOutput]:
    """One frame step from an ADC cube [1, A, C, S] (baseband): the cube
    front end gated by the state's clutter map, then the stateful tail.
    Returns the next state and the frame's :class:`FrameOutput` [1]."""
    _check_cube_supported(cfg)
    _check_signals(signals, cfg)
    fe.use_f32_matmuls()
    p_lin, det, sigs = _cube_front_end(signals, cfg, state.clutter)
    return _step_from_front_end(state, p_lin, det, sigs, cfg, rotate_pose)


def process_scatterers(state: FrameState, scatterers: ScattererBatch,
                       seed: torch.Tensor, cfg: PipelineConfig,
                       rotate_pose: bool = True
                       ) -> Tuple[FrameState, FrameOutput]:
    """One frame step from scatterers [1, S_max] with its noise seed [1]
    (int32): the scatterer front end on its route -- one-pass (K1 / K3,
    the state's clutter map as the kernel's clutter input), three-dispatch
    (K4, detection, K5) or materialized (``synthesize_frame`` with the same
    seed, then the cube front end) -- then the stateful tail."""
    _check_supported(cfg)
    fe.use_f32_matmuls()
    p_lin, det, sigs = _scatterer_front_end(scatterers, seed, cfg,
                                            state.clutter)
    return _step_from_front_end(state, p_lin, det, sigs, cfg, rotate_pose)


def _cat_outputs(outs: List[FrameOutput]) -> FrameOutput:
    """Per-frame (or per-chunk) outputs joined along the frame axis."""
    return FrameOutput(
        motion=MotionEstimate(*[torch.cat(x) for x in
                                zip(*[o.motion for o in outs])]),
        **{name: torch.cat([getattr(o, name) for o in outs])
           for name in FrameOutput._fields if name != "motion"})


def _frame(batch, i: int, j: int):
    """Frames i..j-1 of a NamedTuple of [F, ...] tensors, nested
    NamedTuples included (None kept)."""
    return _map(lambda x: x[i:j], batch)


def process_sequence(scatterers: ScattererBatch, generator: torch.Generator,
                     cfg: PipelineConfig, rotate_pose: bool = True,
                     initial_pose=None) -> FrameOutput:
    """The sequential driver over scatterers [F, S_max]: per-frame seeds
    from ``generator`` (``frame_seeds``, as every driver draws them), then
    :func:`process_scatterers` frame after frame.  Returns a
    :class:`FrameOutput` with leading frame axis [F]."""
    _check_supported(cfg)
    F = scatterers.range_m.shape[0]
    dev = scatterers.range_m.device
    seeds = frame_seeds(generator, F, dev)
    state = init_state(cfg, initial_pose, dev)
    outs = []
    for f in range(F):
        state, out = process_scatterers(state, _frame(scatterers, f, f + 1),
                                        seeds[f:f + 1], cfg, rotate_pose)
        outs.append(out)
    return _cat_outputs(outs)


def process_signal_sequence(signals: torch.Tensor, cfg: PipelineConfig,
                            rotate_pose: bool = True) -> FrameOutput:
    """The sequential driver over ADC cubes [F, A, C, S]:
    :func:`process_signals` frame after frame."""
    _check_cube_supported(cfg)
    _check_signals(signals, cfg)
    state = init_state(cfg, device=signals.device)
    outs = []
    for f in range(signals.shape[0]):
        state, out = process_signals(state, signals[f:f + 1], cfg,
                                     rotate_pose)
        outs.append(out)
    return _cat_outputs(outs)


def process_sequence_chunked(scatterers: ScattererBatch,
                             generator: torch.Generator, cfg: PipelineConfig,
                             rotate_pose: bool = True, initial_pose=None,
                             window: int = 16,
                             prior: str = "jacobi") -> FrameOutput:
    """The sequential semantics over scatterers [F, S_max], the front end
    batched over windows of ``window`` frames.

    Per window, everything frame-independent runs batched: the front end,
    the AoA tail, temporal smoothing (``smooth_windowed`` over the window
    with the last H = (temporal_window - 1) (track_max_age + 1) frames of
    raw measurements carried in, so track chains cross windows) and
    association (an in-window shift with the previous window's last targets
    carried in).  The prior chain of the 6-DoF solve runs as ``prior``
    says: ``"exact"`` solves frame after frame with the previous motion as
    :func:`process_sequence` does; ``"jacobi"`` solves every frame without
    the prior, takes for each frame the params of the last earlier success
    (a ``cummax`` over success indices) and solves again with them, and
    composes the pose as prefix sums with the same coasting rule.

    Equals :func:`process_sequence` (same seeds) up to float reassociation
    while the slot table evicts no fresh track, and, for ``"jacobi"``, the
    relaxation of the prior's chain (its weight is 1e-3 of the data terms).
    Requires ``clutter_map_alpha == 0``.  The last window is padded with
    copies of the last frame, whose outputs are dropped."""
    if prior not in ("exact", "jacobi"):
        raise ValueError(f"Unknown prior mode: {prior}")
    _check_supported(cfg)
    _no_clutter_map(cfg, "process_sequence_chunked")
    fe.use_f32_matmuls()
    F = scatterers.range_m.shape[0]
    dev = scatterers.range_m.device
    W = min(window, F)
    n_chunks = -(-F // W)
    Fp = n_chunks * W
    seeds = frame_seeds(generator, F, dev)
    if Fp > F:
        pad = lambda x: torch.cat([x, x[-1:].expand(Fp - F, *x.shape[1:])])
        scatterers = ScattererBatch(*[None if x is None else pad(x)
                                      for x in scatterers])
        seeds = pad(seeds)
    state = init_state(cfg, initial_pose, dev)
    D = _clutter_shape(cfg)[1]
    K = cfg.detection.max_detections
    H = (cfg.aoa.temporal_window - 1) * (cfg.aoa.track_max_age + 1)
    hist =(torch.full((H, K), -1, dtype=torch.int32, device=dev),
            torch.zeros((H, K), dtype=torch.float32, device=dev),
            torch.zeros((H, K), dtype=torch.float32, device=dev),
            torch.zeros((H, K), dtype=torch.bool, device=dev))
    prev_t, prev_ok = state.prev_targets, state.prev_valid
    prev_m, pose0 = state.prev_motion, state.pose[0]
    outs = []
    for c in range(n_chunks):
        _, det_b, sigs_b = _scatterer_front_end(
            _frame(scatterers, c * W, (c + 1) * W), seeds[c * W:(c + 1) * W],
            cfg)
        features = _aoa_features(det_b, sigs_b, cfg)
        det, _, keep, _, _, angles_deg, _, conf = features

        det_keys = det.range_bin * D + det.doppler_bin           # [W, K]
        hk, ha, hc, hv = hist
        sm_ang, sm_conf = smoothing.smooth_windowed(
            torch.cat([hk, det_keys]), torch.cat([ha, angles_deg]),
            torch.cat([hc, conf]), torch.cat([hv, keep]), cfg.aoa)
        targets = _smoothed_targets(features, sm_ang[H:], sm_conf[H:], cfg)

        prev_b = Targets(*[None if p is None else torch.cat([p, x[:-1]])
                           for p, x in zip(prev_t, targets)])
        nv = torch.sum(targets.valid, dim=1) > 0                 # [W]
        has_prev = torch.cat([prev_ok, nv[:-1]])
        assoc_b = associate_targets(targets, prev_b, cfg.frame_dt,
                                    cfg.velocity)
        assoc_b = assoc_b._replace(valid=assoc_b.valid & has_prev[:, None])

        if prior == "exact":
            motions, poses = [], []
            pm, ps = prev_m, pose0[None]
            for w in range(W):
                motion, ps, pm = _solve_and_step(
                    _frame(assoc_b, w, w + 1), pm, ps, cfg, rotate_pose)
                motions.append(motion)
                poses.append(ps)
            motion_b = MotionEstimate(*[torch.cat(x)
                                        for x in zip(*motions)])
            pose_b = torch.cat(poses)
            prev_m, pose0 = pm, ps[0]
        else:
            motion_b, pose_b, prev_m = _jacobi_prior_chain(
                assoc_b, prev_m, pose0, cfg, rotate_pose)
            pose0 = pose_b[-1]

        outs.append(FrameOutput(
            motion=motion_b, pose=pose_b,
            num_detections=torch.sum(det.valid, dim=1).to(torch.int32),
            num_reliable=torch.sum(targets.is_reliable,
                                   dim=1).to(torch.int32),
            num_associations=torch.sum(assoc_b.valid,
                                       dim=1).to(torch.int32),
            target_xy=targets.position[..., :2],
            target_valid=targets.valid & targets.is_reliable))
        if H > 0:
            hist = tuple(torch.cat([h, x])[-H:] for h, x in zip(
                hist, (torch.where(keep, det_keys, -1).to(torch.int32),
                       angles_deg, conf, keep)))
        prev_t = _frame(targets, W - 1, W)
        prev_ok = nv[-1:]
    return _frame(_cat_outputs(outs), 0, F)


def _jacobi_prior_chain(assoc: Associations, prev_m: torch.Tensor,
                        pose0: torch.Tensor, cfg: PipelineConfig,
                        rotate_pose: bool):
    """The chunked driver's two-sweep relaxation of the prior chain over
    one window's associations [W, K]: sweep 1 without the prior, sweep 2
    with the params of the last sweep-1 success before each frame (the
    carried ``prev_m`` [1, 6] before the first).  Returns (motion [W],
    pose [W, 3] after each frame, the motion carried to the next window)."""
    W = assoc.valid.shape[0]
    dev = assoc.valid.device
    dtf = float(np.float32(cfg.frame_dt))
    idx = torch.arange(W, device=dev)
    v_amb = cfg.radar.max_unambiguous_velocity
    m1 = solve_velocity(assoc, cfg.frame_dt, cfg.radar.lambda_c,
                        cfg.velocity, v_unambiguous=v_amb)
    p1 = torch.cat([m1.velocity, m1.angular_velocity], dim=-1)     # [W, 6]
    j1 = torch.cummax(torch.where(m1.success, idx, -1), dim=0).values
    j1p = torch.cat([torch.full((1,), -1, dtype=j1.dtype, device=dev),
                     j1[:-1]])
    prior_t = torch.where((j1p >= 0)[:, None], p1[torch.clamp(j1p, min=0)],
                          prev_m)
    motion = solve_velocity(assoc, cfg.frame_dt, cfg.radar.lambda_c,
                            cfg.velocity, prev_motion=prior_t,
                            v_unambiguous=v_amb)
    p2 = torch.cat([motion.velocity, motion.angular_velocity], dim=-1)
    j2 = torch.cummax(torch.where(motion.success, idx, -1), dim=0).values
    last = j2[-1:]
    pm_f = torch.where((last >= 0)[:, None], p2[torch.clamp(last, min=0)],
                       prev_m)
    # Failed frames already carry the fallback (prior) velocity, so
    # coasting is the prefix sum of the substituted steps; without
    # coast_on_failure failed steps freeze instead.
    wz = motion.angular_velocity[:, 2]
    v2 = motion.velocity[:, :2]
    if not cfg.pose.coast_on_failure:
        wz = torch.where(motion.success, wz, 0.0)
        v2 = torch.where(motion.success[:, None], v2, 0.0)
    yaw_after = pose0[2] + torch.cumsum(wz * dtf, dim=0)
    yaw_before = yaw_after - wz * dtf
    if rotate_pose:
        c, s = torch.cos(yaw_before), torch.sin(yaw_before)
        step_xy = torch.stack([c * v2[:, 0] - s * v2[:, 1],
                               s * v2[:, 0] + c * v2[:, 1]], dim=-1) * dtf
    else:
        step_xy = v2 * dtf
    xy_after = pose0[None, :2] + torch.cumsum(step_xy, dim=0)
    pose = torch.cat([xy_after, yaw_after[:, None]], dim=-1)
    return motion, pose, pm_f
