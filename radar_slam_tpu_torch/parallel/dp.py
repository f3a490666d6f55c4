"""Frame-parallel SPMD pipeline over the ranks of a mesh.

Counterpart of ``radar_slam_tpu/parallel/dp.py``.  The sequence pipeline
has one cross-frame dependency per stage boundary (association needs the
previous frame's targets; the pose is a prefix sum of per-frame
increments).  Rank r takes the contiguous frame block ``[r*B, (r+1)*B)``
(``mesh.block``) and:

- runs the batched driver's phase A on its block: on the one-pass route
  one front-end kernel launch (K1) over its B frames, over ADC cubes the
  cube front end (K7 at ``fft_mode="fused"``);
- smooths angles with the batched driver's windowed smoother over the raw
  per-frame tables of the WHOLE sequence, all-gathered ([F, K] each, a few
  hundred KB next to the cubes), so the smoothing equals the batched
  driver's exactly;
- associates its first frame with the previous block's last frame (the
  reference's ``ppermute`` halo, here an all-gather of every block's last
  frame, which NCCL and gloo both take on CUDA tensors);
- builds the planar pose as a distributed prefix sum: local cumulative sums
  plus the all-gathered totals of the earlier blocks.

Every rank returns the whole sequence's outputs [F, ...] (the reference's
``out_specs=P(axis)`` gathered).  Seeds: every rank draws
``frame_seeds(generator, F)`` once from the same generator state and
slices its block, so the F-frame outputs equal
``process_sequence_batched``'s on the same generator.
"""

from __future__ import annotations

import numpy as np
import torch

from radar_slam_tpu_torch.aoa import smoothing
from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.types import ScattererBatch, Targets
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.noise import frame_seeds
from radar_slam_tpu_torch.parallel.mesh import Mesh
from radar_slam_tpu_torch.pipeline import frame as frame_mod
from radar_slam_tpu_torch.signal.synth import synthesize_frames_seeded
from radar_slam_tpu_torch.utils.host import device_get, tree_map


def _block_features_scatterers(scatterers: ScattererBatch,
                               seeds: torch.Tensor, cfg: PipelineConfig):
    """Phase A of ``process_sequence_batched`` on frames [B, S_max] and
    their seeds [B]: the one-pass or three-dispatch front end, or the
    materialized cubes through ``frame_features``.  Returns the AoA
    features with the frame axis."""
    if frame_mod._phase_a_route(cfg) != "materialized":
        _, det, sigs = frame_mod._scatterer_front_end(scatterers, seeds, cfg)
        return frame_mod._aoa_features(det, sigs, cfg)
    signals = synthesize_frames_seeded(scatterers, cfg.radar, seeds,
                                       fidelity=cfg.synth_fidelity)
    return frame_mod.frame_features(signals, cfg)


def _targets_from_features(features, cfg: PipelineConfig,
                           mesh: Mesh) -> Targets:
    """Mesh-exact temporal smoothing + target assembly from one block's
    per-frame features: the smoothing inputs (integer track keys, raw
    angles, confidences, keep masks, [B, K] each) are all-gathered, every
    rank runs the windowed smoother over the full [F, K] tables and keeps
    its own block."""
    det, _, keep, _, _, angles_deg, _, conf = features
    B = det.range_bin.shape[0]
    D = frame_mod._clutter_shape(cfg)[1]
    det_keys = det.range_bin * D + det.doppler_bin                # [B, K]
    ang_all, conf_all = smoothing.smooth_windowed(
        *mesh.gather((det_keys, angles_deg, conf, keep)), cfg.aoa)
    rows = slice(mesh.rank * B, (mesh.rank + 1) * B)
    return frame_mod._smoothed_targets(features, ang_all[rows],
                                       conf_all[rows], cfg)


def _block_tail(targets: Targets, cfg: PipelineConfig, mesh: Mesh) -> dict:
    """Association + solve + distributed prefix-sum pose for one block."""
    halo = None
    if mesh.size > 1:
        # Every block's last frame; block r - 1's precedes this one.
        last = mesh.gather(tree_map(lambda x: x[-1:], targets))
        if mesh.rank > 0:
            halo = tree_map(lambda x: x[mesh.rank - 1:mesh.rank], last)
    _, motion = frame_mod._batched_assoc_solve(targets, cfg, halo=halo)

    exclusive = None
    if mesh.size > 1:
        def exclusive(total):
            totals = mesh.gather(total[None])                   # [n, ...]
            return torch.sum(totals[:mesh.rank], dim=0)
    pose = frame_mod._pose_prefix(motion, cfg, True, exclusive)
    return {
        "velocity": motion.velocity,
        "angular_velocity": motion.angular_velocity,
        "success": motion.success,
        "rmse": motion.rmse,
        "pose": pose,
        "num_associations": motion.num_targets,
    }


def process_frames_dp_scatterers(scatterers: ScattererBatch,
                                 generator: torch.Generator,
                                 cfg: PipelineConfig, mesh: Mesh) -> dict:
    """Frame-parallel pipeline from point-cloud scatterers [F, S_max]: the
    batched driver's front end on each rank's frame block (one K1 launch a
    rank on the one-pass route).

    ``generator`` must be in the same state on every rank: each draws the
    F seeds of ``process_sequence_batched`` and keeps its block, so the
    outputs equal that driver's.  F must be a multiple of the mesh size
    (pad upstream).  Returns a dict of per-frame outputs [F, ...] on every
    rank."""
    frame_mod._check_supported(cfg)
    fe.use_f32_matmuls()
    F = scatterers.range_m.shape[0]
    rows = mesh.block(F)
    seeds = frame_seeds(generator, F, scatterers.range_m.device)
    features = _block_features_scatterers(mesh.take(scatterers),
                                          seeds[rows], cfg)
    return mesh.gather(_block_tail(_targets_from_features(features, cfg,
                                                          mesh), cfg, mesh))


def process_frames_dp(signals: torch.Tensor, cfg: PipelineConfig,
                      mesh: Mesh) -> dict:
    """Frame-parallel pipeline over ADC cubes [F, A, C, S] complex64: the
    cube front end (``frame_features``; K7 at ``fft_mode="fused"``) on
    each rank's frame block.  F must be a multiple of the mesh size (pad
    upstream).  Returns a dict of per-frame outputs [F, ...] on every
    rank."""
    frame_mod._check_cube_supported(cfg)
    frame_mod._check_signals(signals, cfg)
    fe.use_f32_matmuls()
    features = frame_mod.frame_features(signals[mesh.block(signals.shape[0])],
                                        cfg)
    return mesh.gather(_block_tail(_targets_from_features(features, cfg,
                                                          mesh), cfg, mesh))


def approximately_equal_to_scan(dp_out: dict, scan_out, atol=1e-3) -> bool:
    """Debug helper: compare dp outputs with the sequential scan driver."""
    a, b = device_get((dp_out["pose"], scan_out.pose))
    return bool(np.allclose(a, b, atol=atol))
