"""The port's sequential drivers against the reference's.

- Configuration: ``config_from_dict`` carries each of the reference's
  configurations across unchanged.
- Stages: the slot-table smoother (``smoothing.update``, keys and counts
  exact, with eviction and stale tracks), the robust AoA stage, the planar
  pose step, the clutter map and its gate.
- Drivers at sigma = 0 on the route the reference takes on the CPU
  (``synth_in_kernel=False``: cubes synthesized, then the cube front end):
  ``process_sequence`` with the clutter map, ``process_sequence_chunked``
  with both priors (a narrower radar: the reference's own chunked test is
  marked slow at the bench size), a continuation from a mid-sequence state,
  and ``process_signal_sequence`` on noisy cubes with the clutter map.
  Jitted, the reference rounds its float32 synthesis phases otherwise than
  eagerly (ROADMAP, port conventions); its drivers therefore take their
  cubes from the eager synthesis here (fixture ``eager_synthesis``), which
  the port's ``synthesize_frame`` reproduces (tests/test_torch_cube.py).
- The one-pass step with the clutter map as the kernel's clutter input,
  composed as the reference's TPU branch of ``process_scatterers``, with
  the kernel in interpret mode.
- One realization per generator state: the port's sequential, chunked and
  batched drivers agree with each other with noise.

Poses are held to 1e-4 m, solve outcomes and counts exactly, unless a test
states the phase-lattice caveat (ROADMAP, section 3).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.aoa import robust as jrobust
from radar_slam_tpu.aoa import smoothing as jsm
from radar_slam_tpu.core import config as jcfg
from radar_slam_tpu.core import types as jtypes
from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
from radar_slam_tpu.motion.pose import planar_pose_step as jpose_step
from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu_torch.aoa import robust as trobust
from radar_slam_tpu_torch.aoa import smoothing as tsm
from radar_slam_tpu_torch.core import config as tcfg
from radar_slam_tpu_torch.core import types as ttypes
from radar_slam_tpu_torch.core.types import (scatterer_batch_from_numpy,
                                             signals_from_numpy)
from radar_slam_tpu_torch.motion.pose import planar_pose_step
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal.synth import (synthesize_frame,
                                               synthesize_frames_batch)


def _port_cfg(ref_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(ref_cfg))


def _bench(noise_power=0.0, **over):
    """The bench configuration on the reference's CPU route, and the
    port's copy of it."""
    ref = dataclasses.replace(bench_config(noise_power=noise_power), **over)
    return ref, _port_cfg(ref)


def _with_clutter(ref, alpha):
    return dataclasses.replace(ref, detection=dataclasses.replace(
        ref.detection, clutter_map_alpha=alpha))


def _narrow(**over):
    """A narrower radar for the chunked driver: 16 chirps, 128 samples
    (250 MHz over 12.8 us: 0.6 m bins out to 76.8 m), 32 detections."""
    ref = jcfg.PipelineConfig(
        radar=jcfg.RadarConfig(noise_power=0.0, num_chirps=16,
                               bandwidth=250e6, chirp_duration=12.8e-6),
        detection=jcfg.DetectionConfig(cfar_train_cells=4, guard_cells=1,
                                       cfar_offset_db=12.0,
                                       max_detections=32),
        aoa=jcfg.AoAConfig(search_resolution_deg=2.0,
                           confidence_threshold=0.5, max_targets=32),
        max_scatterers=64, fft_mode="fused", **over)
    return ref, _port_cfg(ref)


def _narrow_scene(n_frames):
    jbatch, _ = constant_motion_scene(
        5, num_frames=n_frames, dt=0.1, v_body=(6.0, -0.5), yaw_rate=0.08,
        scene=SceneConfig(num_points=48, max_scatterers=64))
    fields = {k: np.asarray(v) for k, v in jbatch._asdict().items()
              if v is not None}
    return jbatch, scatterer_batch_from_numpy(fields, "cpu")


def _assert_outputs(got, ref, pose_atol=1e-4, vel_atol=1e-3):
    for name in ("num_detections", "num_reliable", "num_associations"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  np.asarray(ref.motion.success))
    np.testing.assert_allclose(to_np(got.motion.velocity),
                               np.asarray(ref.motion.velocity), rtol=0,
                               atol=vel_atol)
    np.testing.assert_allclose(to_np(got.pose), np.asarray(ref.pose),
                               rtol=0, atol=pose_atol)


@pytest.fixture
def eager_synthesis(monkeypatch):
    """The reference drivers' ``synthesize_frame``, evaluated eagerly off
    the trace (a host callback into the port's synthesis, which equals the
    reference's eager form).  The configurations here have noise_power 0,
    so the noise key is unused."""

    def host(radar, fidelity, *cols):
        names = ("range_m", "azimuth_rad", "rcs_db", "vr", "valid",
                 "elevation_rad")
        batch = scatterer_batch_from_numpy(
            {n: np.asarray(c)[None] for n, c in zip(names, cols)}, "cpu")
        return to_np(synthesize_frame(batch, radar,
                                      torch.zeros(1, dtype=torch.int32),
                                      add_noise=False,
                                      fidelity=fidelity))[0]

    def synth(scatterers, cfg, key, output="baseband", add_noise=True,
              fidelity="tpu"):
        assert cfg.noise_power == 0.0 and output == "baseband"
        radar = tcfg.RadarConfig(**dataclasses.asdict(cfg))
        cols = [scatterers.range_m, scatterers.azimuth_rad,
                scatterers.rcs_db, scatterers.vr, scatterers.valid]
        if scatterers.elevation_rad is not None:
            cols.append(scatterers.elevation_rad)
        shape = jax.ShapeDtypeStruct(
            (cfg.num_antennas, cfg.num_chirps, cfg.samples_per_chirp),
            jnp.complex64)
        return jax.pure_callback(functools.partial(host, radar, fidelity),
                                 shape, *cols, vmap_method="sequential")

    monkeypatch.setattr(jframe, "synthesize_frame", synth)


# ---- configuration ---------------------------------------------------------

@pytest.mark.parametrize("factory", [
    "complete_analysis_config", "reference_fidelity_config",
    "default_config", "PipelineConfig"])
def test_config_from_dict_round_trip(factory):
    ref = getattr(jcfg, factory)()
    port = tcfg.config_from_dict(dataclasses.asdict(ref))
    assert isinstance(port, tcfg.PipelineConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port == getattr(tcfg, factory)()
    for name in ("lambda_c", "spacing", "total_antennas", "samples_per_chirp",
                 "chirp_rate", "prf", "max_unambiguous_velocity"):
        assert getattr(port.radar, name) == getattr(ref.radar, name), name
    assert port.frame_dt == ref.frame_dt
    assert port.aoa.num_grid_points == ref.aoa.num_grid_points


def test_config_from_dict_keeps_tuples():
    """``chirp_subset`` is a tuple again after a JSON round trip (lists),
    the configuration stays hashable, and unknown fields raise."""
    ref = dataclasses.replace(jcfg.complete_analysis_config(),
                              chirp_subset=(0, 16))
    d = json.loads(json.dumps(dataclasses.asdict(ref)))
    port = tcfg.config_from_dict(d)
    assert port.chirp_subset == (0, 16)
    assert isinstance(port.chirp_subset, tuple)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    hash(port)
    with pytest.raises(TypeError):
        tcfg.config_from_dict({**d, "window_size": 3})


# ---- stages ----------------------------------------------------------------

def test_smoother_update_matches_reference():
    """12 frames of 6 detections over 14 cells into 8 slots, with empty
    frames: tracks are evicted and go stale.  Keys, counts, ages and ring
    buffers exact; smoothed values to float32 rounding."""
    kw = dict(track_capacity=8, temporal_window=3, track_max_age=2)
    jaoa, aoa = jcfg.AoAConfig(**kw), tcfg.AoAConfig(**kw)
    rng = np.random.default_rng(0)
    js, ts = jsm.init_state(jaoa), tsm.init_state(aoa, device="cpu")
    K = 6
    evicted = stale = False
    for f in range(12):
        keys = rng.choice(14, size=K, replace=False).astype(np.int32)
        ang = rng.uniform(-60.0, 60.0, K).astype(np.float32)
        conf = rng.uniform(0.0, 1.0, K).astype(np.float32)
        valid = (rng.random(K) < 0.8) & (f not in (5, 6, 7))
        old_keys = np.asarray(js.keys)
        js, ja, jc = jsm.update(js, jnp.asarray(keys), jnp.asarray(ang),
                                jnp.asarray(conf), jnp.asarray(valid), jaoa)
        ts, ta, tc = tsm.update(ts, torch.tensor(keys), torch.tensor(ang),
                                torch.tensor(conf), torch.tensor(valid), aoa)
        for name in ("keys", "count", "age", "angles", "confs"):
            np.testing.assert_array_equal(to_np(getattr(ts, name)),
                                          np.asarray(getattr(js, name)),
                                          f"frame {f}: {name}")
        np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=0,
                                   atol=1e-6)
        new_keys = np.asarray(js.keys)
        evicted |= bool(np.any((old_keys >= 0) & (new_keys >= 0)
                               & (old_keys != new_keys)))
        stale |= bool(np.any((new_keys >= 0)
                             & (np.asarray(js.age) > kw["track_max_age"])))
    assert evicted and stale


def _random_detections(rng, F, K, R, D):
    """Detections [F, K] on a small pool of cells (so that tracks form
    across frames), as numpy fields."""
    pool = rng.choice(R * D, size=K + 8, replace=False)
    flat = np.stack([rng.choice(pool, size=K, replace=False)
                     for _ in range(F)])
    valid = rng.random((F, K)) < 0.85
    power = np.sort(rng.uniform(-40.0, 0.0, (F, K)), axis=1)[:, ::-1]
    return dict(
        range_bin=(flat // D).astype(np.int32),
        doppler_bin=(flat % D).astype(np.int32),
        range_m=rng.uniform(1.0, 60.0, (F, K)).astype(np.float32),
        doppler_hz=rng.uniform(-2e3, 2e3, (F, K)).astype(np.float32),
        vr_mps=rng.uniform(-9.0, 9.0, (F, K)).astype(np.float32),
        power_db=np.where(valid, power, -np.inf).astype(np.float32),
        valid=valid)


def _signatures(rng, F, K, cfg):
    """Unit-power signatures [F, K, A]: a steering vector plus noise."""
    A = cfg.radar.num_antennas
    az = rng.uniform(-1.0, 1.0, (F, K, 1))
    a = np.arange(A)[None, None, :]
    sig = (np.exp(1j * np.pi * a * np.sin(az))
           + 0.1 * (rng.standard_normal((F, K, A))
                    + 1j * rng.standard_normal((F, K, A))))
    sig /= np.linalg.norm(sig, axis=-1, keepdims=True)
    return sig.astype(np.complex64)


def _assert_targets(got, ref, atol=1e-4):
    for name in ref._fields:
        a, b = to_np(getattr(got, name)), np.asarray(getattr(ref, name))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def test_process_targets_robust_matches_reference():
    """Three frames through the slot table with precomputed signatures,
    against the reference frame by frame."""
    ref_cfg, cfg = _bench()
    rng = np.random.default_rng(1)
    F, K, D = 3, 64, 32
    fields = _random_detections(rng, F, K, 400, D)
    sigs = _signatures(rng, F, K, cfg)
    state_t = tsm.init_state(cfg.aoa, device="cpu")
    got, state_t = trobust.process_targets_robust(
        None, ttypes.Detections(**{k: torch.tensor(v)
                                   for k, v in fields.items()}),
        state_t, cfg.radar, cfg.aoa, signatures=torch.tensor(sigs),
        doppler_bins=D)
    state_j = jsm.init_state(ref_cfg.aoa)
    refs = []
    for f in range(F):
        det = jtypes.Detections(**{k: jnp.asarray(v[f])
                                   for k, v in fields.items()})
        tj, state_j = jrobust.process_targets_robust(
            None, det, state_j, ref_cfg.radar, ref_cfg.aoa,
            signatures=jnp.asarray(sigs[f]), doppler_bins=D)
        refs.append(tj)
    ref = jtypes.Targets(*[np.stack([np.asarray(getattr(t, n))
                                     for t in refs])
                           for n in jtypes.Targets._fields])
    assert ref.is_reliable.sum() > 20
    _assert_targets(got, ref)
    for name in ("keys", "count", "age"):
        np.testing.assert_array_equal(to_np(getattr(state_t, name)),
                                      np.asarray(getattr(state_j, name)))


def test_process_targets_basic_matches_reference():
    """The basic stage from an RDS: signatures gathered at the detected
    cells, no smoothing, every valid detection a target."""
    ref_cfg, cfg = _bench()
    rng = np.random.default_rng(2)
    K, A, R, D = 64, 8, 400, 32
    rds = (rng.standard_normal((A, R, D))
           + 1j * rng.standard_normal((A, R, D))).astype(np.complex64)
    fields = _random_detections(rng, 1, K, R, D)
    ref = jrobust.process_targets(
        jnp.asarray(rds), jtypes.Detections(**{k: jnp.asarray(v[0])
                                               for k, v in fields.items()}),
        ref_cfg.radar, ref_cfg.aoa, method="beamforming")
    got = trobust.process_targets(
        torch.tensor(rds)[None],
        ttypes.Detections(**{k: torch.tensor(v) for k, v in fields.items()}),
        cfg.radar, cfg.aoa, method="beamforming")
    _assert_targets(got, jtypes.Targets(*[
        None if x is None else np.asarray(x)[None] for x in ref]))


@pytest.mark.parametrize("rotate", [True, False])
def test_planar_pose_step_matches_reference(rotate):
    rng = np.random.default_rng(3)
    pose = rng.uniform(-5.0, 5.0, (16, 3)).astype(np.float32)
    vel = rng.uniform(-10.0, 10.0, (16, 3)).astype(np.float32)
    wz = rng.uniform(-1.0, 1.0, 16).astype(np.float32)
    dt = float(np.float32(0.1))
    ref = np.stack([np.asarray(jpose_step(jnp.asarray(p), jnp.asarray(v),
                                          jnp.float32(w), jnp.float32(dt),
                                          rotate))
                    for p, v, w in zip(pose, vel, wz)])
    got = to_np(planar_pose_step(torch.tensor(pose), torch.tensor(vel),
                                 torch.tensor(wz), dt, rotate))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_clutter_map_and_gate_match_reference():
    """The EMA over four frames of RDS power, then the gate on both
    detectors: the persistent returns are suppressed, a fresh one is not,
    as in the reference."""
    ref_cfg, cfg = _bench()
    det_cfg = ref_cfg.detection
    rng = np.random.default_rng(4)
    A, R, D = 8, 400, 32

    def rds_with(peaks):
        x = 1e-4 * (rng.standard_normal((A, R, D))
                    + 1j * rng.standard_normal((A, R, D)))
        for r, d, amp in peaks:
            x[:, r, d] += amp
        return x.astype(np.complex64)

    persistent = [(60, 5, 1.0), (150, 20, 0.5), (300, 9, 2.0)]
    c_ref = jnp.zeros((R, D), jnp.float32)
    c_got = torch.zeros((1, R, D))
    for _ in range(4):
        x = rds_with(persistent)
        c_ref = jdet.clutter_map_update(c_ref, jnp.asarray(x), 0.5)
        c_got = tdet.clutter_map_update(c_got, torch.tensor(x)[None], 0.5)
    np.testing.assert_allclose(to_np(c_got)[0], np.asarray(c_ref),
                               rtol=1e-6, atol=0)
    fresh = rds_with(persistent + [(222, 27, 1.0)])
    p = np.mean(np.abs(fresh) ** 2, axis=0).astype(np.float32)
    for ref, got in (
            (jdet.detect_peaks(jnp.asarray(fresh), ref_cfg.radar, det_cfg,
                               clutter_lin=c_ref),
             tdet.detect_peaks(torch.tensor(fresh)[None], cfg.radar,
                               cfg.detection, clutter_lin=c_got)),
            (jdet.detect_peaks_from_power(jnp.asarray(p), ref_cfg.radar,
                                          det_cfg, clutter_lin=c_ref),
             tdet.detect_peaks_from_power(torch.tensor(p)[None], cfg.radar,
                                          cfg.detection,
                                          clutter_lin=c_got))):
        valid = np.asarray(ref.valid)
        np.testing.assert_array_equal(to_np(got.valid)[0], valid)
        cells = {(int(r), int(d)) for r, d in zip(
            np.asarray(ref.range_bin)[valid],
            np.asarray(ref.doppler_bin)[valid])}
        assert (222, 27) in cells
        assert not cells & {(r, d) for r, d, _ in persistent}
        for name in ("range_bin", "doppler_bin"):
            np.testing.assert_array_equal(to_np(getattr(got, name))[0],
                                          np.asarray(getattr(ref, name)))


# ---- drivers ---------------------------------------------------------------

def test_process_sequence_with_clutter_matches_reference(eager_synthesis):
    """6 frames of the bench scene, clutter map at alpha 0.5: the map gates
    detections from frame 1 on, identically in both."""
    ref_cfg, cfg = _bench(synth_in_kernel=False)
    ref_cfg, cfg = _with_clutter(ref_cfg, 0.5), _with_clutter(cfg, 0.5)
    jbatch, fields, _ = scene_fields(6)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    ref = jframe.process_sequence(jbatch, jax.random.key(0), ref_cfg)
    got = tframe.process_sequence(batch, torch.Generator(), cfg)
    _assert_outputs(got, ref)
    free = tframe.process_sequence(batch, torch.Generator(),
                                   _with_clutter(cfg, 0.0))
    assert (to_np(got.num_detections)[1:].sum()
            < to_np(free.num_detections)[1:].sum())


def test_continuation_from_mid_sequence_state(eager_synthesis):
    """The reference runs 3 frames with the clutter map; its state, carried
    across by ``frame_state_from_numpy``, continues in both packages for 3
    more frames."""
    ref_cfg, cfg = _bench(synth_in_kernel=False)
    ref_cfg, cfg = _with_clutter(ref_cfg, 0.5), _with_clutter(cfg, 0.5)
    jbatch, fields, _ = scene_fields(6)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    state = jframe.init_state(ref_cfg)
    refs = []
    for f in range(6):
        if f == 3:
            snap = jax.tree.map(np.asarray, state)
        state, out = jframe.process_scatterers(
            state, jax.tree.map(lambda x: x[f], jbatch), jax.random.key(f),
            ref_cfg)
        refs.append(jax.tree.map(np.asarray, out))
    fields_np = dict(
        smoother=snap.smoother._asdict(),
        prev_targets=snap.prev_targets._asdict(),
        prev_valid=snap.prev_valid, prev_motion=snap.prev_motion,
        pose=snap.pose, clutter=snap.clutter)
    tstate = tframe.frame_state_from_numpy(fields_np, "cpu")
    assert tstate.clutter.shape == (1, 400, 32)
    assert int(tstate.smoother.count.sum()) > 0
    outs = []
    for f in range(3, 6):
        tstate, out = tframe.process_scatterers(
            tstate, tframe._frame(batch, f, f + 1),
            torch.zeros(1, dtype=torch.int32), cfg)
        outs.append(out)
    ref = jax.tree.map(lambda *x: np.stack(x), *refs[3:])
    _assert_outputs(tframe._cat_outputs(outs), ref)


@pytest.mark.parametrize("prior", ["exact", "jacobi"])
def test_process_sequence_chunked_matches_reference(prior, eager_synthesis):
    """10 frames in windows of 4 (the last one padded), with the temporal
    prior; both priors against the reference's same prior."""
    ref_cfg, cfg = _narrow()
    jbatch, batch = _narrow_scene(10)
    ref = jframe.process_sequence_chunked(jbatch, jax.random.key(0),
                                          ref_cfg, window=4, prior=prior)
    got = tframe.process_sequence_chunked(batch, torch.Generator(), cfg,
                                          window=4, prior=prior)
    assert np.asarray(ref.motion.success)[1:].all()
    _assert_outputs(got, ref)
    if prior == "exact":
        seq = tframe.process_sequence(batch, torch.Generator(), cfg)
        np.testing.assert_allclose(to_np(got.pose), to_np(seq.pose),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("fft_mode", ["fused", "fft"])
def test_process_signal_sequence_with_clutter_matches_reference(fft_mode):
    """Noisy cubes (the same numpy cube in both) through the sequential cube
    driver with the clutter map at alpha 0.5: the fused power map and the
    complex RDS, whose power the map averages."""
    ref_cfg, cfg = _bench(noise_power=1e-6, fft_mode=fft_mode)
    ref_cfg, cfg = _with_clutter(ref_cfg, 0.5), _with_clutter(cfg, 0.5)
    _, fields, _ = scene_fields(5)
    sig = to_np(synthesize_frames_batch(
        scatterer_batch_from_numpy(fields, "cpu"), cfg.radar,
        torch.Generator().manual_seed(15)))
    ref = jframe.process_signal_sequence(jnp.asarray(sig), ref_cfg)
    got = tframe.process_signal_sequence(signals_from_numpy(sig, "cpu"), cfg)
    _assert_outputs(got, ref)


def test_onepass_clutter_step_matches_reference(monkeypatch):
    """The one-pass route with the clutter map as the kernel's clutter
    input, 3 frames at alpha 0.5: the reference's TPU branch of
    ``process_scatterers`` (its frame.py:230-265) composed by hand, the
    kernel in interpret mode at sigma = 0 (waited on), against the port's
    ``process_sequence``.  Phase-lattice caveat: inputs that agree to
    ~1e-4 rad can settle a frame's wrapped-phase solve one lattice step
    (1.95 cm/s) away, so velocities are held to 0.05 m/s and the pose to
    1 cm."""
    waited = jfe.scatterer_frontend_split
    monkeypatch.setattr(jfe, "scatterer_frontend_split",
                        lambda *a, **k: jax.block_until_ready(
                            waited(*a, **k)))
    ref_cfg, cfg = _bench()
    ref_cfg, cfg = _with_clutter(ref_cfg, 0.5), _with_clutter(cfg, 0.5)
    jbatch, fields, _ = scene_fields(3)
    state = jframe.init_state(ref_cfg)
    alpha = ref_cfg.detection.clutter_map_alpha
    refs = []
    for f in range(3):
        sc = jax.tree.map(lambda x: x[f:f + 1], jbatch)
        with pltpu.force_tpu_interpret_mode():
            p_b, det_b, sigs_b = jframe._onepass_frontend(
                sc, jnp.zeros(1, jnp.int32), ref_cfg,
                clutter=state.clutter[None])
            jax.block_until_ready(sigs_b)
        det = jax.tree.map(lambda x: x[0], det_b)
        clutter = jdet.clutter_map_update_from_power(state.clutter, p_b[0],
                                                     alpha)
        targets, smoother = jrobust.process_targets_robust(
            None, det, state.smoother, ref_cfg.radar, ref_cfg.aoa,
            method=ref_cfg.aoa.method, signatures=sigs_b[0],
            doppler_bins=p_b.shape[-1])
        state, out = jframe._step_from_targets(state, det, targets, smoother,
                                               clutter, ref_cfg, True)
        refs.append(jax.tree.map(np.asarray, out))
    ref = jax.tree.map(lambda *x: np.stack(x), *refs)
    got = tframe.process_sequence(scatterer_batch_from_numpy(fields, "cpu"),
                                  torch.Generator(), cfg)
    _assert_outputs(got, ref, pose_atol=1e-2, vel_atol=0.05)


def test_drivers_share_one_noise_realization():
    """With noise, one generator state: the chunked driver (exact prior)
    equals the sequential one, the Jacobi prior stays within 1e-3 m, the
    batched driver equals the sequential one at temporal_weight = 0, and
    the one-pass time-domain route equals the CA three-dispatch route (one
    noisy cube, products in another order).  track_capacity 256: no
    eviction, so the windowed smoother equals the slot table."""
    _, cfg = _bench(noise_power=1e-6)
    cfg = dataclasses.replace(cfg, aoa=dataclasses.replace(
        cfg.aoa, track_capacity=256))
    _, fields, _ = scene_fields(12)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    gen = lambda: torch.Generator().manual_seed(3)
    seq = tframe.process_sequence(batch, gen(), cfg)
    assert to_np(seq.motion.success)[1:].all()
    exact = tframe.process_sequence_chunked(batch, gen(), cfg, window=5,
                                            prior="exact")
    np.testing.assert_allclose(to_np(exact.pose), to_np(seq.pose), rtol=0,
                               atol=1e-5)
    jac = tframe.process_sequence_chunked(batch, gen(), cfg, window=5)
    np.testing.assert_allclose(to_np(jac.pose), to_np(seq.pose), rtol=0,
                               atol=1e-3)
    flat = dataclasses.replace(cfg, velocity=dataclasses.replace(
        cfg.velocity, temporal_weight=0.0))
    np.testing.assert_allclose(
        to_np(tframe.process_sequence_batched(batch, gen(), flat).pose),
        to_np(tframe.process_sequence(batch, gen(), flat).pose), rtol=0,
        atol=1e-4)
    time_cfg = dataclasses.replace(cfg, noise_domain="time")
    onepass = tframe.process_sequence(batch, gen(), time_cfg)
    three = tframe.process_sequence(batch, gen(), dataclasses.replace(
        time_cfg, frontend_one_pass=False))
    np.testing.assert_allclose(to_np(onepass.pose), to_np(three.pose),
                               rtol=0, atol=1e-5)


def _same_outputs(a, b):
    """Two driver outputs equal bit for bit, field by field."""
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(to_np(x), to_np(y))


def test_clutter_map_rules():
    """The reference's rules: the chunked driver refuses the clutter map;
    the batched drivers ignore it (at alpha 0.05 their outputs equal those
    at 0 bit for bit, noise on); an unknown prior raises."""
    _, cfg = _bench(noise_power=1e-6)
    clut = _with_clutter(cfg, 0.05)
    _, fields, _ = scene_fields(2)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    with pytest.raises(ValueError):
        tframe.process_sequence_chunked(batch, torch.Generator(), clut)
    gen = lambda: torch.Generator().manual_seed(4)
    _same_outputs(tframe.process_sequence_batched(batch, gen(), clut),
                  tframe.process_sequence_batched(batch, gen(), cfg))
    sig = synthesize_frames_batch(batch, cfg.radar, gen())
    _same_outputs(tframe.process_signal_sequence_batched(sig, clut),
                  tframe.process_signal_sequence_batched(sig, cfg))
    with pytest.raises(ValueError):
        tframe.process_sequence_chunked(batch, torch.Generator(), cfg,
                                        prior="gauss_seidel")


def test_reference_batched_driver_ignores_the_clutter_map():
    """The rule the port follows: the reference's batched cube driver at
    alpha 0.05 gives its own output at 0 (it never reads the map)."""
    ref_cfg, cfg = _narrow()
    _, batch = _narrow_scene(3)
    sig = jnp.asarray(to_np(synthesize_frames_batch(
        batch, cfg.radar, torch.Generator().manual_seed(2))))
    _same_outputs(
        jframe.process_signal_sequence_batched(
            sig, _with_clutter(ref_cfg, 0.05)),
        jframe.process_signal_sequence_batched(sig, ref_cfg))
