"""The batched pipelines: scatterers or ADC cubes in, poses out.

Counterpart of ``radar_slam_tpu/pipeline/frame.py`` for its two batched
drivers, each in two phases.  Phase A is frame-independent and runs over
all frames at once:

- :func:`process_sequence_batched` (scatterers [F, S_max]) routes as a TPU
  does (the reference's frame.py:653-657 and :781-793):
  - **one-pass** at ``fft_mode="fused"`` with ``synth_in_kernel``,
    ``frontend_one_pass`` and CA-CFAR: synthesis factors (split, or dense
    with ``frontend_factors="dense"``) -> the front-end kernel (K1, or K3)
    -> exact top-K + Z-column signatures -> detections -- the path of
    ``complete_analysis_config()``;
  - **three-dispatch** at ``fft_mode="fused"`` with ``synth_in_kernel``
    otherwise (OS-CFAR, or ``frontend_one_pass=False``): dense factors ->
    power map from the factors (K4) -> detection -> signatures from the
    factors (K5) (:func:`sequence_features_scatterers_fused`);
  - **materialized** otherwise: the ADC cubes are synthesized and go
    through :func:`frame_features`.
  The three-dispatch and materialized paths draw one noise realization
  per generator state (``ops/noise.py``, element (a*C + c) * S + s).
- :func:`process_signal_sequence_batched` (cubes [F, A, C, S]) runs
  :func:`frame_features`: the fused power map (``fft_mode="fused"``) or the
  complex RDS (``"fft"``, ``"matmul"``, ``"pallas"``), CA- or OS-CFAR
  detection, signatures.

Both end in the AoA tail.  Phase B runs windowed temporal smoothing,
mutual-NN association with the previous frame, the batched 6-DoF solve and
a prefix-sum pose.  There is no backend branch: the device of the input
tensors decides whether a kernel launches its CUDA code (``cuda``) or runs
its plain PyTorch version (``cpu``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.aoa import confidence as conf_mod
from radar_slam_tpu_torch.aoa import estimators, smoothing
from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.types import (Detections, FrameOutput,
                                             MotionEstimate, ScattererBatch,
                                             Targets)
from radar_slam_tpu_torch.motion.associate import associate_targets
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
                                               synthesize_frames_batch)


def _check_common(cfg: PipelineConfig) -> None:
    if cfg.detection.cfar_mode not in ("ca", "os"):
        raise ValueError(f"Unknown cfar_mode: {cfg.detection.cfar_mode}")
    if cfg.detection.clutter_map_alpha > 0:
        raise ValueError("the batched pipeline requires clutter_map_alpha "
                         "== 0 (the clutter EMA makes detection sequential)")
    if cfg.chirp_subset is not None:
        raise NotImplementedError("chirp_subset is not ported")
    if cfg.radar.num_antennas_el != 1:
        raise NotImplementedError(
            "num_antennas_el > 1 (a 2-D array) is not ported (ROADMAP: "
            "MUSIC / ESPRIT and URA arrays)")


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
                      cfg: PipelineConfig):
    """Front end over a frame batch: synthesis factors (split, or dense
    with ``frontend_factors="dense"``) -> kernel (K1, or K3) -> exact
    top-K + signatures -> detections.  Returns (p_lin [F, R, D],
    Detections [F, K], sigs [F, K, A])."""
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
        doppler_window=cfg.doppler_window, noise_impl=cfg.noise_impl,
        noise_domain=cfg.noise_domain,
        noise_taps=window_freq_taps(cfg.window),
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
            precision_name=cfg.power_precision,
            doppler_precision=cfg.synth_doppler_precision,
            doppler_layout=cfg.synth_doppler_layout, **common)
    det = detect_mod.detections_from_topk(p_lin, rb, db, vals, cfg.radar,
                                          cfg.detection)
    return p_lin, det, sigs


def sequence_features_scatterers_fused(scatterers: ScattererBatch,
                                       generator: torch.Generator,
                                       cfg: PipelineConfig):
    """Phase A for scatterers [F, S_max] without a cube through torch: the
    one-pass front end (see :func:`_phase_a_route`), or the three-dispatch
    path -- the power map straight from the dense synthesis factors (K4),
    detection on it (CA- or OS-CFAR), then the detected cells' signatures
    from the factors with the same noise (K5).  The seeds come from
    ``generator`` as the materialized path draws them, so both see one
    noise realization.  Returns the AoA features with the frame axis."""
    if cfg.chirp_subset is not None:
        raise ValueError("synth_in_kernel requires chirp_subset=None")
    F = scatterers.range_m.shape[0]
    dev = scatterers.range_m.device
    seeds = frame_seeds(generator, F, dev)
    if _phase_a_route(cfg) == "one_pass":
        _, det, sigs = _onepass_frontend(scatterers, seeds, cfg)
        return _aoa_features(det, sigs, cfg)

    C = cfg.radar.num_chirps
    S = cfg.radar.samples_per_chirp
    sigma = float(cfg.radar.noise_power) ** 0.5
    mix = _mix_vector(cfg.radar, cfg.window, "baseband", S, device=dev)
    e_ac, e_fast = synthesis_factors(scatterers, cfg.radar,
                                     cfg.synth_fidelity)
    p_lin = sp.scatterer_power(e_ac, e_fast, seeds, mix, C, sigma,
                               doppler_window=cfg.doppler_window,
                               precision_name=cfg.power_precision,
                               doppler_precision=cfg.synth_doppler_precision,
                               doppler_layout=cfg.synth_doppler_layout,
                               noise_impl=cfg.noise_impl)
    det = detect_mod.detect_peaks_from_power(p_lin, cfg.radar, cfg.detection)
    sigs = sp.scatterer_signatures(e_ac, e_fast, seeds, det.range_bin,
                                   det.doppler_bin, mix, C, sigma,
                                   doppler_window=cfg.doppler_window,
                                   noise_impl=cfg.noise_impl)
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


def _batched_assoc_solve(targets: Targets, cfg: PipelineConfig
                         ) -> Tuple[torch.Tensor, MotionEstimate]:
    """Association with the previous frame (a shift, not a scan) and the
    velocity solve, batched over frames; no temporal prior."""
    F = targets.range_m.shape[0]
    prev = Targets(*[None if x is None else torch.cat([x[:1], x[:-1]])
                     for x in targets])
    assoc = associate_targets(targets, prev, cfg.frame_dt, cfg.velocity)
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


def _sequence_from_features(features, cfg: PipelineConfig,
                            rotate_pose: bool) -> FrameOutput:
    """Phase B: windowed temporal smoothing, shift-association, batched
    solves, prefix-sum pose."""
    (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
     conf) = features
    D = cfg.radar.num_chirps
    det_keys = det.range_bin * D + det.doppler_bin                # [F, K]
    angles_s, conf_s = smoothing.smooth_windowed(
        det_keys, angles_deg, conf, keep, cfg.aoa)

    reliable = keep & (conf_s >= cfg.aoa.confidence_threshold) & ~is_multi
    targets = Targets(
        range_bin=det.range_bin, doppler_bin=det.doppler_bin,
        range_m=det.range_m, doppler_hz=det.doppler_hz,
        vr_mps=det.vr_mps, power_db=det.power_db,
        azimuth_rad=torch.deg2rad(angles_s), confidence=conf_s,
        num_sources=num_sources, is_multipath=is_multi,
        is_reliable=reliable, spatial_signature=sigs, valid=keep,
        elevation_rad=torch.deg2rad(el_deg))

    n_assoc, motion = _batched_assoc_solve(targets, cfg)
    pose = _pose_prefix(motion, cfg, rotate_pose)
    return FrameOutput(
        motion=motion, pose=pose,
        num_detections=torch.sum(det.valid, dim=-1).to(torch.int32),
        num_reliable=torch.sum(reliable, dim=-1).to(torch.int32),
        num_associations=n_assoc.to(torch.int32),
        target_xy=targets.position[..., :2],
        target_valid=targets.valid & targets.is_reliable)


def frame_features(signals: torch.Tensor, cfg: PipelineConfig):
    """Phase A of the cube-input path over ADC cubes [F, A, C, S]:
    RDS or power map -> detection -> signatures -> the AoA tail.

    ``fft_mode="fused"`` takes the power map straight from the cubes
    (``rds_power``: the K7 kernel on a CUDA tensor) and recomputes only the
    detected cells' signatures; the other modes build the complex RDS
    (``"pallas"``: the K8 kernel; ``"fft"`` with ``use_pallas``: the K9
    kernel) and detect on it (with ``use_pallas``: the K10 kernel).

    Returns (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
    conf), each with the leading frame axis."""
    if cfg.fft_mode == "fused":
        p_lin = rds_power(signals, cfg.radar, window=cfg.window,
                          chirp_subset=cfg.chirp_subset,
                          doppler_window=cfg.doppler_window,
                          dft_precision=cfg.power_precision,
                          doppler_precision=cfg.doppler_precision,
                          doppler_layout=cfg.doppler_layout)
        det = detect_mod.detect_peaks_from_power(p_lin, cfg.radar,
                                                 cfg.detection)
        sigs = detection_signatures(signals, det.range_bin, det.doppler_bin,
                                    cfg.radar, window=cfg.window,
                                    chirp_subset=cfg.chirp_subset,
                                    doppler_window=cfg.doppler_window)
    else:
        rds = range_doppler_spectrum(signals, cfg.radar, window=cfg.window,
                                     chirp_subset=cfg.chirp_subset,
                                     doppler_window=cfg.doppler_window,
                                     use_pallas=cfg.use_pallas,
                                     fft_mode=cfg.fft_mode,
                                     dft_precision=cfg.dft_precision)
        det = detect_mod.detect_peaks(rds, cfg.radar, cfg.detection,
                                      use_pallas=cfg.use_pallas)
        sigs = detect_mod.extract_spatial_signatures(rds, det)
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
    r = cfg.radar
    want = (r.num_antennas, r.num_chirps, r.samples_per_chirp)
    if signals.dim() != 4 or tuple(signals.shape[1:]) != want:
        raise ValueError(f"signals: need [F, {want[0]}, {want[1]}, "
                         f"{want[2]}], got {tuple(signals.shape)}")
    if signals.dtype != torch.complex64:
        raise TypeError(f"signals: dtype {signals.dtype} != complex64")
    fe.use_f32_matmuls()
    features = frame_features(signals, cfg)
    return _sequence_from_features(features, cfg, rotate_pose)
