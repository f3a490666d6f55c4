"""The mounted multi-sensor rig pipeline.

Counterpart of ``radar_slam_tpu/pipeline/rig.py``.  Each sensor is
processed in its own frame -- synthesis, detection, AoA and temporal
smoothing, batched over the sensor axis -- and its targets are then merged
into the vehicle frame with their sensor's origin, so that association and
the 6-DoF solve see the exact mounting geometry.  With two or more sensors
the lever arm s x d makes yaw rate observable from Doppler alone.

The layout is static: sensor b owns target slots [b*K, (b+1)*K) of the
merged set, and a block id (``group``) keeps associations within a sensor.

Routes, as the reference's on a TPU: the one-pass front end (K1, or K3
with ``frontend_factors="dense"``) where the scatterer driver takes it
(``frame._phase_a_route(cfg) == "one_pass"``), over the flattened
(frame x sensor) axis; otherwise the ADC cubes are synthesized and go
through the cube front end.  The rig has no three-dispatch route.

Seeds: every driver draws ``frame_seeds(generator, F * B)`` and reads it
as [F, B] in row-major order, so the batched and the sequential rig see
the same noise at one generator state, and a one-sensor rig draws the
seeds :func:`frame.process_sequence_batched` draws.

- :func:`process_sequence_rig_batched`: phase A over all F * B (frame,
  sensor) pairs at once, then per-sensor windowed smoothing, the merge,
  shift-association within sensor blocks, batched solves without the
  temporal prior, a prefix-sum pose.  The clutter map is ignored, as in
  the reference's batched drivers.
- :func:`process_sequence_rig`: :func:`process_scatterers_rig` frame after
  frame, with one slot-table smoother per sensor and, when
  ``clutter_map_alpha > 0``, a clutter map [B, R, D] that gates detection
  (the one-pass kernel's clutter input).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radar_slam_tpu_torch.aoa import smoothing
from radar_slam_tpu_torch.aoa.robust import process_targets_robust
from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.types import (FrameOutput, ScattererBatch,
                                             Targets)
from radar_slam_tpu_torch.motion.associate import associate_targets
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.noise import frame_seeds
from radar_slam_tpu_torch.pipeline import frame as fr
from radar_slam_tpu_torch.pipeline.frame import FrameState
from radar_slam_tpu_torch.signal import detect as detect_mod
from radar_slam_tpu_torch.signal.synth import synthesize_frames_seeded
from radar_slam_tpu_torch.utils.profiling import span

Rig = Tuple[Tuple[float, float, float], ...]  # (x, y, yaw) per sensor

COLOCATED: Rig = ((0.0, 0.0, 0.0),)


def rig_arrays(rig: Rig, device=DEFAULT):
    """(mount_xy [B, 2], mount_yaw [B]) float32 on ``device``."""
    m = torch.tensor(rig, dtype=torch.float32, device=resolve(device))
    return m[:, :2], m[:, 2]


def _sensor_layout(mount_xy: torch.Tensor, K: int):
    """Per merged target slot: its sensor's origin [B*K, 3] (mounts are
    planar, z = 0) and its sensor-block id [B*K] int32."""
    B = mount_xy.shape[0]
    sensor_pos = torch.cat([mount_xy, torch.zeros_like(mount_xy[:, :1])],
                           dim=-1).repeat_interleave(K, dim=0)
    group = torch.arange(B, dtype=torch.int32,
                         device=mount_xy.device).repeat_interleave(K)
    return sensor_pos, group


def _check_rig(scatterers: ScattererBatch, rig: Rig, axis: int) -> None:
    """Scatterers carry the sensor axis at ``axis`` (0 for one frame's
    [B, S], 1 for a sequence's [F, B, S]), one entry per mount."""
    shape = tuple(scatterers.range_m.shape)
    if len(shape) != axis + 2 or shape[axis] != len(rig):
        want = ("F, " if axis else "") + f"B={len(rig)}, S"
        raise ValueError(f"scatterers: need [{want}], got {shape}")


def init_rig_state(cfg: PipelineConfig, rig: Rig, initial_pose=None,
                   device=DEFAULT) -> FrameState:
    """The state before the first frame on ``device`` (the card unless the
    caller names another): one empty smoother table per sensor ([B, ...]
    fields), no previous targets in the merged [1, B*K] layout, zero
    motion, the initial pose, and a zero clutter map [B, R, D] when
    ``clutter_map_alpha > 0``."""
    B = len(rig)
    base = fr.init_state(cfg, initial_pose, device)
    return base._replace(
        smoother=fr._map(lambda x: x.expand(B, *x.shape).clone(),
                      base.smoother),
        prev_targets=fr._map(lambda x: torch.cat([x] * B, dim=1),
                          base.prev_targets),
        clutter=(None if base.clutter is None
                 else base.clutter.expand(B, -1, -1).clone()))


def _to_vehicle_frame(targets: Targets, mount_xy: torch.Tensor,
                      mount_yaw: torch.Tensor) -> Targets:
    """Re-express sensor-frame targets [..., B, K] in the vehicle frame:
    range and azimuth (and elevation) become vehicle-origin polar, so that
    ``Targets.position`` is the vehicle-frame position; vr stays
    sensor-radial (the solver takes it with the sensor's line of sight).
    Mounts are planar (z = 0)."""
    mx, my = mount_xy[:, 0, None], mount_xy[:, 1, None]
    ce = (torch.cos(targets.elevation_rad)
          if targets.elevation_rad is not None else 1.0)
    az_v = targets.azimuth_rad + mount_yaw[:, None]
    rh = targets.range_m * ce
    x = mx + rh * torch.cos(az_v)
    y = my + rh * torch.sin(az_v)
    rh_v = torch.hypot(x, y)
    if targets.elevation_rad is None:
        return targets._replace(range_m=rh_v, azimuth_rad=torch.atan2(y, x))
    z = targets.range_m * torch.sin(targets.elevation_rad)
    return targets._replace(range_m=torch.hypot(rh_v, z),
                            azimuth_rad=torch.atan2(y, x),
                            elevation_rad=torch.atan2(z, rh_v))


def _rig_front_end(scatterers: ScattererBatch, seeds: torch.Tensor,
                   cfg: PipelineConfig,
                   clutter: Optional[torch.Tensor] = None):
    """The per-(frame, sensor) front end over scatterers [N, S] and their
    seeds [N]: the one-pass kernel on its route, else synthesized cubes
    and the cube front end.  Returns (p_lin, Detections [N, K],
    sigs [N, K, A])."""
    if fr._phase_a_route(cfg) == "one_pass":
        return fr._onepass_frontend(scatterers, seeds, cfg, clutter)
    signals = synthesize_frames_seeded(scatterers, cfg.radar, seeds,
                                       fidelity=cfg.synth_fidelity)
    return fr._cube_front_end(signals, cfg, clutter)


def process_scatterers_rig(state: FrameState, scatterers: ScattererBatch,
                           seeds: torch.Tensor, cfg: PipelineConfig,
                           rig: Rig, rotate_pose: bool = True
                           ) -> Tuple[FrameState, FrameOutput]:
    """One frame step from per-sensor scatterer sets [B, S] (each in its
    sensor's frame) and their noise seeds [B] int32: the front end over
    the sensor axis (gated by the state's clutter map), the clutter-map
    update, each sensor's robust AoA stage through its own smoother table,
    then :func:`_rig_tail`.  Returns the next state and the frame's
    :class:`FrameOutput` [1].  Spans: ``step.front_end``, ``step.aoa``,
    ``step.tail``."""
    fr._check_supported(cfg)
    _check_rig(scatterers, rig, 0)
    fe.use_f32_matmuls()
    with span("step.front_end"):
        p_lin, det, sigs = _rig_front_end(scatterers, seeds, cfg,
                                          state.clutter)
    with span("step.aoa"):
        clutter = (detect_mod.clutter_map_update_from_power(
            state.clutter, p_lin, cfg.detection.clutter_map_alpha)
            if state.clutter is not None else None)
        targets, smoothers = [], []
        for b in range(len(rig)):
            t_b, sm_b = process_targets_robust(
                None, fr._frame(det, b, b + 1),
                fr._map(lambda x: x[b], state.smoother), cfg.radar, cfg.aoa,
                method=cfg.aoa.method, signatures=sigs[b:b + 1],
                doppler_bins=fr._clutter_shape(cfg)[1])
            targets.append(t_b)
            smoothers.append(sm_b)
        targets_b = Targets(*[None if x[0] is None else torch.cat(x)
                              for x in zip(*targets)])           # [B, K]
        smoother = smoothing.SmootherState(*[torch.stack(x)
                                             for x in zip(*smoothers)])
    return _rig_tail(state, targets_b, smoother, clutter, cfg, rig,
                     rotate_pose)


def _rig_tail(state: FrameState, targets_b: Targets,
              smoother: smoothing.SmootherState, clutter, cfg, rig: Rig,
              rotate_pose: bool) -> Tuple[FrameState, FrameOutput]:
    """The stateful tail of a rig step: the vehicle-frame merge [1, B*K],
    association with the previous merged targets within sensor blocks
    (lines of sight from each target's sensor), the 6-DoF solve with the
    previous motion as its prior, the pose, the next state."""
    with span("step.tail"):
        K = targets_b.range_m.shape[-1]
        mount_xy, mount_yaw = rig_arrays(rig, targets_b.range_m.device)
        merged = fr._map(lambda x: x.flatten(1, 2), _to_vehicle_frame(
            fr._map(lambda x: x[None], targets_b), mount_xy, mount_yaw))
        sensor_pos, group = _sensor_layout(mount_xy, K)
        assoc = associate_targets(merged, state.prev_targets, cfg.frame_dt,
                                  cfg.velocity, sensor_pos=sensor_pos,
                                  group=group)
        assoc = assoc._replace(valid=assoc.valid & state.prev_valid[:, None])
        motion, pose, prev_motion = fr._solve_and_step(
            assoc, state.prev_motion, state.pose, cfg, rotate_pose)
        new_state = FrameState(
            smoother=smoother, prev_targets=merged,
            prev_valid=torch.sum(merged.valid, dim=-1) > 0,
            prev_motion=prev_motion, pose=pose, clutter=clutter)
        pos = merged.position
        out = FrameOutput(
            motion=motion, pose=pose,
            num_detections=torch.sum(
                targets_b.valid).reshape(1).to(torch.int32),
            num_reliable=torch.sum(merged.is_reliable,
                                   dim=-1).to(torch.int32),
            num_associations=assoc.num_valid.to(torch.int32),
            target_xy=pos[..., :2],
            target_valid=merged.valid & merged.is_reliable,
            target_z=pos[..., 2])
    return new_state, out


def sequence_features_rig(scatterers: ScattererBatch,
                          generator: torch.Generator, cfg: PipelineConfig,
                          rig: Rig):
    """Phase A of the batched rig driver over scatterers [F, B, S]: seeds
    ``frame_seeds(generator, F * B)`` read as [F, B], then
    :func:`_features_from_frame_seeds`.  Returns the AoA features with
    leading axes [F, B]."""
    _check_rig(scatterers, rig, 1)
    F, B = scatterers.range_m.shape[:2]
    seeds = frame_seeds(generator, F * B, scatterers.range_m.device)
    return _features_from_frame_seeds(scatterers, seeds.reshape(F, B), cfg)


def _features_from_frame_seeds(scatterers: ScattererBatch,
                               seeds: torch.Tensor, cfg: PipelineConfig):
    """Phase A from per-(frame, sensor) seeds [F, B]: the front end (the
    one-pass kernel with (frame x sensor) as its frame axis, or the
    synthesized cubes) and the AoA tail over the flattened F * B axis,
    reshaped to [F, B, ...] (span ``phase_a``)."""
    F, B = seeds.shape
    with span("phase_a"):
        flat = fr._map(lambda x: x.flatten(0, 1), scatterers)
        _, det, sigs = _rig_front_end(flat, seeds.reshape(-1), cfg)
        return fr._map(lambda x: x.reshape(F, B, *x.shape[1:]),
                       fr._aoa_features(det, sigs, cfg))


def process_sequence_rig_batched(scatterers: ScattererBatch,
                                 generator: torch.Generator,
                                 cfg: PipelineConfig, rig: Rig,
                                 rotate_pose: bool = True) -> FrameOutput:
    """Throughput-oriented rig driver over per-sensor scatterers [F, B, S]:
    :func:`sequence_features_rig`, then :func:`_rig_sequence_from_features`.
    Matches :func:`process_sequence_rig` up to the temporal motion prior,
    which it drops (``temporal_weight=0`` makes the two equal while no
    smoother table evicts a fresh track), and the clutter map, which it
    ignores.  Returns a :class:`FrameOutput` with leading frame axis [F]
    over the merged [B*K] targets.  Spans: ``call``, ``phase_a``,
    ``phase_b``."""
    fr._check_supported(cfg)
    fe.use_f32_matmuls()
    with span("call", frames=scatterers.range_m.shape[0]):
        features = sequence_features_rig(scatterers, generator, cfg, rig)
        with span("phase_b"):
            return _rig_sequence_from_features(features, cfg, rig,
                                               rotate_pose)


def _rig_sequence_from_features(features, cfg: PipelineConfig, rig: Rig,
                                rotate_pose: bool = True) -> FrameOutput:
    """Phase B of the batched rig driver from features [F, B, ...]: each
    sensor's [F, K] columns smoothed on their own (``smooth_windowed``),
    the vehicle-frame merge [F, B*K], shift-association within sensor
    blocks, batched solves with per-target sensor origins, prefix-sum
    pose."""
    det, _, keep, _, _, angles_deg, _, conf = features
    F, B, K = det.range_bin.shape
    D = fr._clutter_shape(cfg)[1]
    mount_xy, mount_yaw = rig_arrays(rig, det.range_bin.device)
    det_keys = det.range_bin * D + det.doppler_bin              # [F, B, K]
    smoothed = [smoothing.smooth_windowed(det_keys[:, b], angles_deg[:, b],
                                          conf[:, b], keep[:, b], cfg.aoa)
                for b in range(B)]
    angles_s = torch.stack([a for a, _ in smoothed], dim=1)
    conf_s = torch.stack([c for _, c in smoothed], dim=1)
    targets = _to_vehicle_frame(
        fr._smoothed_targets(features, angles_s, conf_s, cfg), mount_xy,
        mount_yaw)
    merged = fr._map(lambda x: x.flatten(1, 2), targets)           # [F, B*K]
    sensor_pos, group = _sensor_layout(mount_xy, K)
    n_assoc, motion = fr._batched_assoc_solve(merged, cfg,
                                              sensor_pos=sensor_pos,
                                              group=group)
    pose = fr._pose_prefix(motion, cfg, rotate_pose)
    pos = merged.position
    return FrameOutput(
        motion=motion, pose=pose,
        num_detections=torch.sum(keep, dim=(1, 2)).to(torch.int32),
        num_reliable=torch.sum(merged.is_reliable, dim=-1).to(torch.int32),
        num_associations=n_assoc.to(torch.int32),
        target_xy=pos[..., :2],
        target_valid=merged.valid & merged.is_reliable,
        target_z=pos[..., 2])


def process_sequence_rig(scatterers: ScattererBatch,
                         generator: torch.Generator, cfg: PipelineConfig,
                         rig: Rig, rotate_pose: bool = True,
                         initial_pose=None) -> FrameOutput:
    """The sequential rig driver over per-sensor scatterers [F, B, S]:
    seeds ``frame_seeds(generator, F * B)`` read as [F, B], then
    :func:`process_scatterers_rig` frame after frame.  Returns a
    :class:`FrameOutput` with leading frame axis [F]."""
    fr._check_supported(cfg)
    _check_rig(scatterers, rig, 1)
    F, B = scatterers.range_m.shape[:2]
    dev = scatterers.range_m.device
    seeds = frame_seeds(generator, F * B, dev).reshape(F, B)
    state = init_rig_state(cfg, rig, initial_pose, dev)
    outs = []
    for f in range(F):
        state, out = process_scatterers_rig(
            state, fr._map(lambda x: x[f], scatterers), seeds[f], cfg, rig,
            rotate_pose)
        outs.append(out)
    return fr._cat_outputs(outs)
