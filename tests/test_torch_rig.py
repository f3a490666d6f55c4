"""The port's mounted-rig drivers, its rig and adversarial scenes, and
association with sensor origins, against the reference's.

- Scenes: ``constant_motion_scene_rig`` and ``mismatch_scene`` give
  bit-identical columns for the same seed (the numpy core is copied).
- Association: ``associate_targets`` with ``sensor_pos``, ``group`` and
  both metrics against the vmapped reference, on numpy-seeded targets.
- Batched rig at sigma = 0 against the composition a TPU runs: the
  one-pass kernel in interpret mode over the flattened F * B frames ->
  ``_aoa_features`` -> reshape [F, B] -> ``rig._rig_sequence_from_features``
  (test_torch_pipeline.py's thresholds).
- Sequential rig against the reference's ``process_sequence_rig`` on the
  materialized route at sigma = 0, the clutter map on (the reference fed
  the eager cube), and the one-pass rig step with the clutter map as the
  kernel's clutter input against the reference's TPU branch composed by
  hand.
- Properties (the reference's tests/test_rig.py): a one-sensor colocated
  rig equals the single-sensor drivers; yaw rate is recovered from Doppler
  alone by a two-sensor rig and not by a colocated sensor; with noise the
  sequential rig equals the batched one at temporal_weight 0; the rig and
  the adversarial scenes meet bench.py's gates on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, patch_eager_synthesis, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.aoa import robust as jrobust
from radar_slam_tpu.core import config as jcfg
from radar_slam_tpu.core import types as jtypes
from radar_slam_tpu.io import synthetic as jsyn
from radar_slam_tpu.motion.associate import associate_targets as jassoc
from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.pipeline import rig as jrig
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu_torch.core import types as ttypes
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
from radar_slam_tpu_torch.io import synthetic as tsyn
from radar_slam_tpu_torch.motion.associate import associate_targets as tassoc
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.pipeline import rig as trig

# Front-left / front-right mounted sensors (tests/test_rig.py:31).
RIG2 = ((1.8, 0.9, 0.4), (1.8, -0.9, -0.4))
# bench.py's four-sensor rig (bench.py:265-266).
RIG4 = ((3.6, 0.8, 0.55), (3.6, -0.8, -0.55),
        (2.4, 0.9, 1.48), (2.4, -0.9, -1.48))
# chip_smoke.py's generator seed for the accuracy gates (PIPELINE_SEED).
GATE_SEED = 1


def _port(ref_cfg):
    return config_from_dict(dataclasses.asdict(ref_cfg))


def _fields(batch):
    return {k: np.asarray(v) for k, v in batch._asdict().items()
            if v is not None}


def _rig_scene(n_frames, rig=RIG2, seed=11, num_points=48, yaw_rate=0.05,
               fov_rad=2.4):
    """The reference's rig scene (its numpy core) and its columns on the
    CPU for the port."""
    scene = jsyn.SceneConfig(num_points=num_points, max_scatterers=128,
                             fov_rad=fov_rad)
    jbatch, gt = jsyn.constant_motion_scene_rig(
        seed, num_frames=n_frames, dt=0.1, v_body=(8.0, 0.5),
        yaw_rate=yaw_rate, rig=rig, scene=scene)
    return jbatch, scatterer_batch_from_numpy(_fields(jbatch), "cpu"), gt


def _check_slice(got, ref, n_frames):
    """test_torch_pipeline.py's slice tolerance: counts, solve outcomes and
    reliable targets exact (positions to 1 mm); velocities to 0.05 m/s
    with half the frames within 1e-3 (the wrapped-phase solve can settle a
    lattice step of 1.95 cm/s away), the pose to 1 cm."""
    for name in ("num_detections", "num_reliable", "num_associations",
                 "target_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      to_np(getattr(ref, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  to_np(ref.motion.success))
    valid = to_np(ref.target_valid)
    np.testing.assert_allclose(to_np(got.target_xy)[valid],
                               to_np(ref.target_xy)[valid], rtol=0,
                               atol=1e-3)
    dv = np.abs(to_np(got.motion.velocity) - to_np(ref.motion.velocity))
    assert dv.max() < 0.05, dv
    assert (dv.max(axis=1) < 1e-3).sum() >= n_frames // 2, dv
    np.testing.assert_allclose(to_np(got.pose), to_np(ref.pose), rtol=0,
                               atol=1e-2)


def _assert_same(got, want, pose_atol=1e-4, vel_atol=1e-3):
    """tests/test_rig.py:180-208's tolerances: pose 1e-4 (relative and
    absolute), velocity 1e-3, solve outcomes and counts exact."""
    np.testing.assert_allclose(to_np(got.pose), to_np(want.pose),
                               rtol=pose_atol, atol=pose_atol)
    np.testing.assert_allclose(to_np(got.motion.velocity),
                               to_np(want.motion.velocity), rtol=vel_atol,
                               atol=vel_atol)
    for name in ("num_reliable", "num_detections"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      to_np(getattr(want, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  to_np(want.motion.success))


# ---- scenes ----------------------------------------------------------------

def _assert_columns_equal(tbatch, jbatch):
    for name, want in _fields(jbatch).items():
        got = to_np(getattr(tbatch, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, name)


def test_rig_scene_columns_bit_identical():
    """bench.py's 4-sensor scene (seed 7, 6 frames): [F, B, S] columns
    and ground truth equal bit for bit."""
    kw = dict(num_frames=6, dt=0.1, v_body=(8.0, 0.5), yaw_rate=0.05,
              rig=RIG4)
    jb, jgt = jsyn.constant_motion_scene_rig(
        7, scene=jsyn.SceneConfig(num_points=96, max_scatterers=128), **kw)
    tb, tgt = tsyn.constant_motion_scene_rig(
        7, scene=tsyn.SceneConfig(num_points=96, max_scatterers=128),
        device="cpu", **kw)
    assert tuple(tb.range_m.shape) == (6, 4, 128)
    _assert_columns_equal(tb, jb)
    for k, v in jgt.items():
        np.testing.assert_array_equal(np.asarray(tgt[k]), np.asarray(v), k)


@pytest.mark.parametrize("knobs", [
    dict(num_movers=4, mover_points=3, mover_oncoming=True,
         clutter_per_frame=10),
    dict(num_movers=3, extent_points=2, dt_jitter_frac=0.2,
         drop_frame_prob=0.3, clutter_per_frame=4)])
def test_mismatch_scene_columns_bit_identical(knobs):
    """bench.py's adversarial scene (bench.py:299-315) and one with every
    other knob on: columns and ground truth bit for bit."""
    args = (3, 12, 0.1, (8.0, 0.5), 0.1)
    jb, jgt = jsyn.mismatch_scene(
        *args, jsyn.SceneConfig(num_points=48, max_scatterers=128),
        jsyn.MismatchConfig(**knobs))
    tb, tgt = tsyn.mismatch_scene(
        *args, tsyn.SceneConfig(num_points=48, max_scatterers=128),
        tsyn.MismatchConfig(**knobs), device="cpu")
    _assert_columns_equal(tb, jb)
    for k, v in jgt.items():
        np.testing.assert_array_equal(np.asarray(tgt[k]), np.asarray(v), k)
    xy, yaw = tsyn.twist_poses(np.linspace(0, 2, 9), np.array([8.0, 0.5]),
                               0.1)
    jxy, jyaw = jsyn.twist_poses(np.linspace(0, 2, 9), np.array([8.0, 0.5]),
                                 0.1)
    np.testing.assert_array_equal(xy, jxy)
    np.testing.assert_array_equal(yaw, jyaw)


# ---- association -----------------------------------------------------------

def _random_targets(rng, F, K, A=8):
    cols = dict(
        range_bin=rng.integers(0, 400, (F, K)).astype(np.int32),
        doppler_bin=rng.integers(0, 32, (F, K)).astype(np.int32),
        range_m=rng.uniform(3.0, 50.0, (F, K)).astype(np.float32),
        doppler_hz=rng.normal(size=(F, K)).astype(np.float32),
        vr_mps=rng.normal(size=(F, K)).astype(np.float32),
        power_db=rng.uniform(0, 30, (F, K)).astype(np.float32),
        azimuth_rad=rng.uniform(-1.0, 1.0, (F, K)).astype(np.float32),
        confidence=rng.uniform(0.3, 1.0, (F, K)).astype(np.float32),
        num_sources=np.ones((F, K), np.int32),
        is_multipath=np.zeros((F, K), bool),
        is_reliable=rng.random((F, K)) < 0.85,
        spatial_signature=(rng.normal(size=(F, K, A))
                           + 1j * rng.normal(size=(F, K, A))
                           ).astype(np.complex64),
        valid=rng.random((F, K)) < 0.9,
        elevation_rad=np.zeros((F, K), np.float32))
    return cols


@pytest.mark.parametrize("metric", ["cartesian", "polar"])
@pytest.mark.parametrize("rig_args", [True, False])
def test_associate_targets_with_sensor_origins_matches(metric, rig_args):
    """3 frames of 2 x 12 targets; the previous set is the current one
    moved by up to 0.5 m / 0.05 rad (so most match), with ``sensor_pos``
    and ``group`` (two blocks of 12) or without.  Indices, matches and
    counts exact; floats to 1e-5 relative and absolute (float32 rounding
    of a few operations), apparent velocities to 1e-4 m/s."""
    rng = np.random.default_rng(0)
    F, K = 3, 24
    cur = _random_targets(rng, F, K)
    prev = dict(cur, range_m=(cur["range_m"] + rng.uniform(
        -0.5, 0.5, (F, K))).astype(np.float32),
        azimuth_rad=(cur["azimuth_rad"] + rng.uniform(
            -0.05, 0.05, (F, K))).astype(np.float32),
        spatial_signature=_random_targets(rng, F, K)["spatial_signature"],
        valid=rng.random((F, K)) < 0.9)
    perm = rng.permutation(K)
    prev = {k: v[:, perm] for k, v in prev.items()}
    kw = {}
    if rig_args:
        mounts = np.array([[1.8, 0.9, 0.0], [1.8, -0.9, 0.0]], np.float32)
        kw = dict(sensor_pos=np.repeat(mounts, K // 2, axis=0),
                  group=np.repeat(np.arange(2, dtype=np.int32), K // 2))
    ref_cfg = bench_config()
    want = jax.vmap(lambda c, p: jassoc(
        c, p, 0.1, ref_cfg.velocity, metric=metric,
        **{k: jnp.asarray(v) for k, v in kw.items()}))(
            jtypes.Targets(**{k: jnp.asarray(v) for k, v in cur.items()}),
            jtypes.Targets(**{k: jnp.asarray(v) for k, v in prev.items()}))
    got = tassoc(ttypes.Targets(**{k: torch.tensor(v)
                                   for k, v in cur.items()}),
                 ttypes.Targets(**{k: torch.tensor(v)
                                   for k, v in prev.items()}),
                 0.1, _port(ref_cfg).velocity, metric=metric,
                 **{k: torch.tensor(v) for k, v in kw.items()})
    assert np.asarray(want.valid).sum() > F * K // 3
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    hit = np.asarray(want.valid)
    np.testing.assert_array_equal(to_np(got.prev_index)[hit],
                                  np.asarray(want.prev_index)[hit])
    for name in ("distance", "temporal_phase_diff", "position", "direction",
                 "weight"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # A difference of positions ~50 m apart by < 1 m, over dt = 0.1 s: the
    # positions' float32 rounding (4e-6 m) makes 4e-5 m/s.
    np.testing.assert_allclose(to_np(got.apparent_velocity),
                               np.asarray(want.apparent_velocity), rtol=0,
                               atol=1e-4)


# ---- the rig drivers against the reference ---------------------------------

@pytest.fixture
def waited_frontend(monkeypatch):
    """The reference's one-pass kernel waits for its result: in interpret
    mode a kernel's io_callbacks dispatch JAX work of their own, and a
    caller that runs ahead can deadlock the CPU client."""
    kernel = jfe.scatterer_frontend_split
    monkeypatch.setattr(jfe, "scatterer_frontend_split",
                        lambda *a, **k: jax.block_until_ready(
                            kernel(*a, **k)))


def test_rig_batched_matches_reference_composition(waited_frontend):
    """F = 4 frames, B = 2 sensors, 48 points per sensor, sigma = 0: the
    one-pass kernel over the flattened 8 (frame, sensor) frames."""
    F, B = 4, len(RIG2)
    ref_cfg = bench_config(noise_power=0.0)
    jbatch, batch, _ = _rig_scene(F)
    flat = jax.tree.map(lambda x: x.reshape((F * B,) + x.shape[2:]), jbatch)
    with pltpu.force_tpu_interpret_mode():
        _, det, sigs = jframe._onepass_frontend(
            flat, jnp.arange(F * B, dtype=jnp.int32), ref_cfg)
        jax.block_until_ready(sigs)
    feats = jax.vmap(lambda d, s: jframe._aoa_features(d, s, ref_cfg))(
        det, sigs)
    feats = jax.tree.map(lambda x: x.reshape((F, B) + x.shape[1:]), feats)
    ref = jrig._rig_sequence_from_features(feats, ref_cfg, RIG2, True)
    got = trig.process_sequence_rig_batched(
        batch, torch.Generator().manual_seed(0), _port(ref_cfg), RIG2)
    assert to_np(got.num_detections).min() > 20
    assert np.asarray(ref.motion.success)[1:].all()
    _check_slice(got, ref, F)


def test_rig_sequential_matches_reference_materialized(monkeypatch):
    """The reference's ``process_sequence_rig`` on its CPU route (cubes
    synthesized per sensor, the fused power map) at sigma = 0, 4 frames of
    two sensors with the clutter map at alpha 0.5, against the port's
    sequential rig on the materialized route (``synth_in_kernel=False``):
    test_torch_pipeline.py's thresholds.  Targets agree to 1e-5 m here, and
    one frame's wrapped-phase solve settles one lattice step (1.8 cm/s)
    from the reference's, with or without the clutter map."""
    patch_eager_synthesis(monkeypatch, jrig)
    ref_cfg = dataclasses.replace(bench_config(noise_power=0.0),
                                  synth_in_kernel=False)
    ref_cfg = dataclasses.replace(ref_cfg, detection=dataclasses.replace(
        ref_cfg.detection, clutter_map_alpha=0.5))
    jbatch, batch, _ = _rig_scene(4)
    ref = jrig.process_sequence_rig(jbatch, jax.random.key(0), ref_cfg,
                                    RIG2)
    got = trig.process_sequence_rig(batch, torch.Generator(), _port(ref_cfg),
                                    RIG2)
    assert np.asarray(ref.motion.success)[1:].all()
    _check_slice(got, ref, 4)


def test_onepass_rig_step_matches_reference(waited_frontend):
    """The one-pass rig step with the clutter map (alpha 0.5) as the
    kernel's clutter input, 3 frames of two sensors at sigma = 0: the
    reference's TPU branch of ``process_scatterers_rig`` (its rig.py:129-152)
    composed by hand with the kernel in interpret mode, against the port's
    ``process_sequence_rig``; test_torch_pipeline.py's thresholds (the
    phase-lattice caveat)."""
    ref_cfg = bench_config(noise_power=0.0)
    ref_cfg = dataclasses.replace(ref_cfg, detection=dataclasses.replace(
        ref_cfg.detection, clutter_map_alpha=0.5))
    F, B = 3, len(RIG2)
    jbatch, batch, _ = _rig_scene(F)
    alpha = ref_cfg.detection.clutter_map_alpha
    mount_xy, mount_yaw = jrig.rig_arrays(RIG2)
    state = jrig.init_rig_state(ref_cfg, RIG2)

    def aoa_tail(det, sigs, sm, cl, p):
        cl = jdet.clutter_map_update_from_power(cl, p, alpha)
        targets, sm = jrobust.process_targets_robust(
            None, det, sm, ref_cfg.radar, ref_cfg.aoa,
            method=ref_cfg.aoa.method, signatures=sigs,
            doppler_bins=p.shape[-1])
        return targets, sm, cl

    refs = []
    for f in range(F):
        sc = jax.tree.map(lambda x: x[f], jbatch)
        with pltpu.force_tpu_interpret_mode():
            p_b, det_b, sigs_b = jframe._onepass_frontend(
                sc, jnp.zeros(B, jnp.int32), ref_cfg, clutter=state.clutter)
            jax.block_until_ready(sigs_b)
        targets_b, smoother, clutter = jax.vmap(aoa_tail)(
            det_b, sigs_b, state.smoother, state.clutter, p_b)
        state, out = jrig._rig_tail(state, targets_b, smoother, clutter,
                                    ref_cfg, RIG2, mount_xy, mount_yaw, True)
        refs.append(jax.tree.map(np.asarray, out))
    ref = jax.tree.map(lambda *x: np.stack(x), *refs)
    got = trig.process_sequence_rig(batch, torch.Generator(), _port(ref_cfg),
                                    RIG2)
    free = trig.process_sequence_rig(
        batch, torch.Generator(), _port(bench_config(noise_power=0.0)), RIG2)
    assert (to_np(got.num_detections)[1:].sum()
            < to_np(free.num_detections)[1:].sum())
    _check_slice(got, ref, F)


# ---- properties -------------------------------------------------------------

@pytest.mark.parametrize("driver", ["batched", "sequential"])
def test_colocated_rig_matches_single_sensor_driver(driver):
    """A one-sensor rig at the origin reproduces the single-sensor driver
    with noise at one generator state (the same seeds): pose 1e-4,
    velocity 1e-3 (tests/test_rig.py:137-160)."""
    cfg = _port(bench_config())
    tbatch, _ = tsyn.constant_motion_scene(
        3, num_frames=5, dt=cfg.frame_dt, v_body=(6.0, 0.0), yaw_rate=0.0,
        scene=tsyn.SceneConfig(num_points=48, max_scatterers=128),
        device="cpu")
    rig_batch = ttypes.ScattererBatch(*[None if x is None else x[:, None]
                                        for x in tbatch])
    gen = lambda: torch.Generator().manual_seed(5)             # noqa: E731
    if driver == "batched":
        want = tframe.process_sequence_batched(tbatch, gen(), cfg)
        got = trig.process_sequence_rig_batched(rig_batch, gen(), cfg,
                                                trig.COLOCATED)
    else:
        want = tframe.process_sequence(tbatch, gen(), cfg)
        got = trig.process_sequence_rig(rig_batch, gen(), cfg,
                                        trig.COLOCATED)
    assert to_np(want.motion.success)[1:].all()
    np.testing.assert_allclose(to_np(got.pose), to_np(want.pose), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got.motion.velocity),
                               to_np(want.motion.velocity), rtol=1e-3,
                               atol=1e-3)


# tests/test_rig.py:23-37: its configuration and scene.
RIG_TEST_CFG = jcfg.PipelineConfig(
    radar=jcfg.RadarConfig(noise_power=1e-6, num_chirps=32),
    detection=jcfg.DetectionConfig(threshold_db=-10.0, max_detections=64),
    aoa=jcfg.AoAConfig(search_resolution_deg=1.0, confidence_threshold=0.5,
                       max_targets=50, track_capacity=64),
    velocity=jcfg.VelocityConfig())


@pytest.mark.parametrize("driver", ["sequential", "batched"])
def test_yaw_rate_from_doppler_alone(driver):
    """tests/test_rig.py:211-225 on the port: Doppler-only solve, no
    apparent-velocity rows, 10 frames of two mounted sensors at yaw rate
    0.25 rad/s: w_z within 0.08 of 0.25 on frames 1..9.  A colocated
    sensor sees the same motion without the lever arm: its estimate stays
    below 0.05."""
    ref_cfg = dataclasses.replace(RIG_TEST_CFG, velocity=dataclasses.replace(
        RIG_TEST_CFG.velocity, mode="doppler", use_apparent_velocity=False))
    cfg = _port(ref_cfg)
    _, batch, _ = _rig_scene(10, yaw_rate=0.25, fov_rad=1.8)
    run = (trig.process_sequence_rig if driver == "sequential"
           else trig.process_sequence_rig_batched)
    out = run(batch, torch.Generator().manual_seed(0), cfg, RIG2)
    w = to_np(out.motion.angular_velocity)[1:, 2]
    np.testing.assert_allclose(w, 0.25, atol=0.08)
    if driver == "sequential":
        mono, _ = tsyn.constant_motion_scene(
            11, num_frames=10, dt=cfg.frame_dt, v_body=(8.0, 0.5),
            yaw_rate=0.25, scene=tsyn.SceneConfig(
                num_points=48, max_scatterers=cfg.max_scatterers,
                fov_rad=1.8), device="cpu")
        w0 = to_np(tframe.process_sequence(
            mono, torch.Generator().manual_seed(0),
            cfg).motion.angular_velocity)[1:, 2]
        assert np.abs(w0).max() < 0.05, w0


def test_sequential_rig_equals_batched_with_noise():
    """bench.py's 4-sensor rig, 6 frames with noise, one generator state,
    temporal_weight 0 and track_capacity 256 (no fresh track evicted):
    tests/test_rig.py:180-208's tolerances."""
    cfg = _port(bench_config())
    cfg = dataclasses.replace(
        cfg, velocity=dataclasses.replace(cfg.velocity, temporal_weight=0.0),
        aoa=dataclasses.replace(cfg.aoa, track_capacity=256))
    _, batch, _ = _rig_scene(6, rig=RIG4, seed=7, num_points=96)
    a = trig.process_sequence_rig(batch, torch.Generator().manual_seed(3),
                                  cfg, RIG4)
    b = trig.process_sequence_rig_batched(
        batch, torch.Generator().manual_seed(3), cfg, RIG4)
    assert to_np(a.motion.success)[1:].all()
    _assert_same(b, a)


def test_rig_and_adversarial_scenes_meet_bench_gates_on_cpu():
    """With noise at generator seed 1 (chip_smoke.py's): bench.py's rig
    gate (the 32-frame 4-sensor scene, position RMSE <= 0.10 m,
    bench.py:257-296) through the batched rig, and its adversarial gate
    (movers and clutter, RMSE <= 0.777 m, bench.py:299-315) through the
    batched driver."""
    cfg = _port(bench_config())
    tb, gt = tsyn.constant_motion_scene_rig(
        7, num_frames=32, dt=cfg.frame_dt, v_body=(8.0, 0.5), yaw_rate=0.05,
        rig=RIG4, scene=tsyn.SceneConfig(num_points=96, max_scatterers=128),
        device="cpu")
    out = trig.process_sequence_rig_batched(
        tb, torch.Generator().manual_seed(GATE_SEED), cfg, RIG4)
    pose = to_np(out.pose)
    assert pose.shape == (32, 3) and np.isfinite(pose).all()
    assert planar_pose_errors(pose, gt["poses"])["position_rmse"] <= 0.10
    mm = tsyn.MismatchConfig(num_movers=4, mover_points=3,
                             mover_oncoming=True, clutter_per_frame=10)
    ab, agt = tsyn.mismatch_scene(
        3, 12, cfg.frame_dt, (8.0, 0.5), 0.1,
        tsyn.SceneConfig(num_points=48, max_scatterers=128), mm,
        device="cpu")
    out = tframe.process_sequence_batched(
        ab, torch.Generator().manual_seed(GATE_SEED), cfg)
    assert planar_pose_errors(to_np(out.pose),
                              agt["poses"])["position_rmse"] <= 0.777


def test_rig_inputs_are_checked():
    cfg = _port(bench_config())
    _, batch, _ = _rig_scene(2)
    with pytest.raises(ValueError):
        trig.process_sequence_rig_batched(batch, torch.Generator(), cfg,
                                          RIG4)
    with pytest.raises(ValueError):
        trig.process_scatterers_rig(
            trig.init_rig_state(cfg, RIG2, device="cpu"), batch,
            torch.zeros(2, dtype=torch.int32), cfg, RIG2)
