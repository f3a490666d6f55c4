"""URA arrays (``RadarConfig.num_antennas_el > 1``) and joint azimuth /
elevation estimation in the port against the JAX reference on the CPU.

Tolerances, with their reasons:

- steering vectors 1e-5: the phase reaches 10 pi = 31.4 rad, where a
  float32 ulp is 1.9e-6 rad, and one ulp of cos(el) sin(az) between the
  two libms moves it by up to 7 pi ulp(1) = 1.3e-6 rad more (the ULA's
  tolerance in tests/test_torch_constants.py is 4e-6 at 7 pi); synthesis
  factors 1e-6 of the maximum, their phases reduced in cycles first (the
  ULA's in tests/test_torch_cube.py); a ULA's factors stay bit for bit
  what the azimuth-only form gave.
- the elevation grid to 2 ulps of its largest value (the reference's
  float32 linspace against a float64 one rounded once, as
  tests/test_torch_constants.py holds the azimuth grid); the joint grid's
  steering 1e-5.
- ``_refine_peak_2d``, beamforming, MUSIC (with and without
  ``music_fb``) and ESPRIT (weighted and lag 1): angles to 1e-3 deg, as
  tests/test_torch_subspace.py holds the ULA; spectra 1e-5 of each row's
  maximum; confidences 1e-5.
- the 3-D scene bit for bit (its numpy core is the reference's).
- the joint recovery of tests/test_elevation.py:48-95 through the port's
  plain versions: its gates, 2 deg in azimuth and 3 deg in elevation.
- the one-pass URA driver on 2 frames at a small shape (4 x 2 elements,
  16 chirps, 128 samples, 16 scatterers) against the composition a TPU
  runs (``_onepass_frontend`` with the kernel in interpret mode, then
  ``_aoa_features`` and ``_sequence_from_features``) at sigma = 0: counts,
  masks and solve outcomes exact, elevations and target positions to
  1e-3, velocities to 1e-3 m/s, poses to 1e-4 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.aoa import confidence as jconf
from radar_slam_tpu.aoa import estimators as je
from radar_slam_tpu.core import config as jcfg
from radar_slam_tpu.core import geometry as jgeo
from radar_slam_tpu.io import synthetic as jsyn
from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.signal import synth as jsynth
from radar_slam_tpu_torch.aoa import confidence as tconf
from radar_slam_tpu_torch.aoa import estimators as te
from radar_slam_tpu_torch.core import geometry as tgeo
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import (ScattererBatch,
                                             scatterer_batch_from_numpy)
from radar_slam_tpu_torch.io import synthetic as tsyn
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.signal import synth as tsynth
from radar_slam_tpu_torch.signal.detect import (detect_peaks,
                                                extract_spatial_signatures)
from radar_slam_tpu_torch.signal.rds import range_doppler_spectrum

# tests/test_elevation.py:25-36: the 8 x 4 URA and its AoA grid.
URA = jcfg.RadarConfig(num_chirps=32, num_antennas=8, num_antennas_el=4,
                       noise_power=1e-6)
AOA = jcfg.AoAConfig(search_resolution_deg=1.0, el_min_deg=-45.0,
                     el_max_deg=45.0, el_resolution_deg=1.5,
                     confidence_threshold=0.5, max_targets=50,
                     track_capacity=64)
CFG = jcfg.PipelineConfig(
    radar=URA,
    detection=jcfg.DetectionConfig(threshold_db=-10.0, max_detections=64),
    aoa=AOA, velocity=jcfg.VelocityConfig(z_velocity_weight=1.0))
TCFG = config_from_dict(dataclasses.asdict(CFG))


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _scene_3d(n_frames, seed=31, num_points=48, max_scatterers=None):
    return jsyn.constant_motion_scene_3d(
        seed, num_frames=n_frames, dt=CFG.frame_dt, v_body=(8.0, 0.5, 1.0),
        yaw_rate=0.05,
        scene=jsyn.SceneConfig(num_points=num_points,
                               max_scatterers=(max_scatterers
                                               or CFG.max_scatterers)),
        z_span=5.0)


def _fields(batch):
    return {k: np.asarray(v) for k, v in batch._asdict().items()
            if v is not None}


def _ura_signatures(seed, n=40, noise=0.2):
    """URA steering vectors at random (az, el) inside the grid with
    complex noise, the last quarter pure noise: complex64 [n, 32]."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-1.0, 1.0, n)
    el = rng.uniform(-0.6, 0.6, n)
    tone = np.asarray(jgeo.ura_steering_vector(
        jnp.asarray(az, jnp.float32), jnp.asarray(el, jnp.float32), 8, 4,
        URA.spacing, URA.spacing_el, URA.lambda_c)).astype(np.complex128)
    tone[3 * n // 4:] = 0.0
    amp = rng.uniform(0.5, 2.0, (n, 1))
    w = rng.normal(size=(n, 32)) + 1j * rng.normal(size=(n, 32))
    return (amp * tone + noise * w).astype(np.complex64)


# ---- geometry, grids, synthesis ------------------------------------------------

def test_ura_steering_vector_matches_and_reduces_to_ula():
    rng = np.random.default_rng(0)
    az = rng.uniform(-1.2, 1.2, (3, 7)).astype(np.float32)
    el = rng.uniform(-0.7, 0.7, (3, 7)).astype(np.float32)
    for n_el in (1, 4):
        want = np.asarray(jgeo.ura_steering_vector(
            jnp.asarray(az), jnp.asarray(el), 8, n_el, URA.spacing,
            URA.spacing_el, URA.lambda_c))
        got = to_np(tgeo.ura_steering_vector(
            torch.tensor(az), torch.tensor(el), 8, n_el, URA.spacing,
            URA.spacing_el, URA.lambda_c))
        assert got.shape == want.shape == (3, 7, 8 * n_el)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # tests/test_elevation.py:39-45, its inputs and tolerance: at el = 0 a
    # one-row URA is the ULA.
    az = torch.linspace(-1.2, 1.2, 7)
    ula = tgeo.steering_vector(az, 8, URA.spacing, URA.lambda_c)
    ura = tgeo.ura_steering_vector(az, torch.zeros(7), 8, 1, URA.spacing,
                                   URA.spacing_el, URA.lambda_c)
    np.testing.assert_allclose(to_np(ura), to_np(ula), rtol=0, atol=1e-6)


def test_scene_3d_bit_identical():
    jbatch, jgt = _scene_3d(4)
    tbatch, tgt = tsyn.constant_motion_scene_3d(
        31, num_frames=4, dt=CFG.frame_dt, v_body=(8.0, 0.5, 1.0),
        yaw_rate=0.05,
        scene=tsyn.SceneConfig(num_points=48,
                               max_scatterers=CFG.max_scatterers),
        z_span=5.0, device="cpu")
    for name, want in _fields(jbatch).items():
        got = to_np(getattr(tbatch, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, name)
    assert tbatch.elevation_rad is not None
    for name, want in jgt.items():
        np.testing.assert_array_equal(np.asarray(tgt[name]),
                                      np.asarray(want), name)


def test_synthesis_factors_at_the_ura_and_the_ula_bit_for_bit():
    """Dense and split factors at the URA against the reference; at a ULA
    the antenna factor equals the azimuth-only form bit for bit."""
    jbatch, _ = _scene_3d(2, num_points=24, max_scatterers=32)
    batch = scatterer_batch_from_numpy(_fields(jbatch), "cpu")
    e_ac_j, e_fast_j = jax.vmap(
        lambda s: jsynth.synthesis_factors(s, URA))(jbatch)
    e_ac, e_fast = tsynth.synthesis_factors(batch, URA)
    assert e_ac.shape == (2, 32, 32 * 32)
    assert rel(to_np(e_ac), e_ac_j) < 1e-6
    assert rel(to_np(e_fast), e_fast_j) < 1e-6
    split_j = jax.vmap(lambda s: jsynth.synthesis_factors_split(s, URA))(
        jbatch)
    split = tsynth.synthesis_factors_split(batch, URA)
    assert split.ant.shape == (2, 32, 32)
    for name in ("ant", "dopp", "coarse", "fine", "tau"):
        assert rel(to_np(getattr(split, name)),
                   getattr(split_j, name)) < 1e-6, name
    ula = dataclasses.replace(URA, num_antennas_el=1)
    ant = tsynth.synthesis_factors_split(batch, ula).ant
    az, el = batch.azimuth_rad, batch.elevation_rad
    u_y = torch.cos(el) * torch.sin(az)
    pos = torch.arange(8, dtype=torch.float32) * ula.spacing
    ok = batch.valid & (batch.range_m > 0)
    r_safe = torch.where(ok, batch.range_m, 1.0)
    amp = torch.where(ok, torch.sqrt(torch.pow(10.0, batch.rcs_db / 10.0))
                      / (4.0 * np.pi * r_safe ** 2), 0.0)
    old = (tsynth.expj_cycles((1.0 / ula.lambda_c) * (u_y[..., None] * pos))
           * amp[..., None])
    assert torch.equal(ant, old)


def test_grids_and_joint_steering_match():
    np.testing.assert_allclose(to_np(te.elevation_grid_deg(AOA, "cpu")),
                               np.asarray(je.elevation_grid_deg(AOA)),
                               rtol=0, atol=2 * np.spacing(np.float32(45)))
    want = np.asarray(je.grid_steering_matrix(URA, AOA))
    got = to_np(te.grid_steering_matrix(URA, AOA, "cpu"))
    assert got.shape == want.shape == (181 * 61, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_refine_peak_2d_matches_edges_and_flat_spectra():
    """Random spectra [K, 7, 9] with peaks planted at the corners and
    edges, flat rows (no refinement) and ties (the first maximum)."""
    rng = np.random.default_rng(2)
    spec = rng.random((12, 7, 9)).astype(np.float32)
    for k, (e, a) in enumerate([(0, 0), (6, 8), (0, 4), (3, 0), (6, 3),
                                (3, 8)]):
        spec[k, e, a] = 5.0
    spec[6] = 1.0                                    # flat
    spec[7, 2, 3] = spec[7, 4, 5] = 9.0              # a tie
    spec[8, 3, 4], spec[8, 3, 3], spec[8, 3, 5] = 4.0, 4.0, 4.0
    az = np.linspace(-8.0, 8.0, 9).astype(np.float32)
    el = np.linspace(-6.0, 6.0, 7).astype(np.float32)
    want = je._refine_peak_2d(jnp.asarray(spec), jnp.asarray(az),
                              jnp.asarray(el))
    got = te._refine_peak_2d(torch.tensor(spec), torch.tensor(az),
                             torch.tensor(el))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=0,
                                   atol=1e-3)
    # A leading frame axis: [2, 6, 7, 9] gives the same angles.
    got2 = te._refine_peak_2d(torch.tensor(spec).reshape(2, 6, 7, 9),
                              torch.tensor(az), torch.tensor(el))
    np.testing.assert_array_equal(to_np(got2[0]).ravel(), to_np(got[0]))


# ---- estimators and confidence --------------------------------------------------

@pytest.mark.parametrize("method,fb,weighted", [
    ("beamforming", False, True), ("music", False, True),
    ("music", True, True), ("esprit", False, True),
    ("esprit", False, False)])
def test_estimators_match_at_the_ura(method, fb, weighted):
    aoa = dataclasses.replace(AOA, music_fb=fb, esprit_weighted=weighted)
    taoa = config_from_dict(dataclasses.asdict(
        dataclasses.replace(CFG, aoa=aoa))).aoa
    s = _ura_signatures(3)
    n = np.random.default_rng(1).integers(1, 3, s.shape[0]).astype(np.int32)
    wa, we, wsp = je.estimate_angles_2d(jnp.asarray(s), URA, aoa, method,
                                        jnp.asarray(n))
    ga, ge, gsp = te.estimate_angles_2d(torch.tensor(s), TCFG.radar, taoa,
                                        method, torch.tensor(n))
    np.testing.assert_allclose(to_np(ga), np.asarray(wa), rtol=0, atol=1e-3)
    np.testing.assert_allclose(to_np(ge), np.asarray(we), rtol=0, atol=1e-3)
    assert np.abs(to_np(ge)).max() > 5.0
    assert (gsp is None) == (wsp is None) == (method == "esprit")
    if gsp is not None:
        w = np.asarray(wsp)
        scale = np.abs(w).max(axis=-1, keepdims=True)
        assert (np.abs(to_np(gsp) - w) / scale).max() < 1e-5
    # estimate_angles: the azimuth of the same joint estimate.
    wa1, _ = je.estimate_angles(jnp.asarray(s), URA, aoa, method,
                                jnp.asarray(n))
    ga1, _ = te.estimate_angles(torch.tensor(s), TCFG.radar, taoa, method,
                                torch.tensor(n))
    np.testing.assert_allclose(to_np(ga1), np.asarray(wa1), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("array", ["ura", "ula"])
def test_spectra_over_chunks_equal_one_product(array, monkeypatch):
    """Beamforming spectra and MUSIC null spectra computed over chunks of
    signatures (budgets cut so that 40 signatures take chunks of 3, the
    last one short) equal the unchunked product to 1e-6 of each row's
    maximum: each row is its own product, the chunking only bounds the
    intermediates."""
    s = torch.tensor(_ura_signatures(5))
    cfg = TCFG
    if array == "ula":
        cfg = dataclasses.replace(TCFG, radar=dataclasses.replace(
            TCFG.radar, num_antennas_el=1))
        s = s[:, :8].contiguous()
    steering = te.grid_steering_matrix(cfg.radar, cfg.aoa, "cpu")
    G, A = steering.shape
    n = torch.full((s.shape[0],), 2, dtype=torch.int32)
    whole = (te.beamforming_spectrum(s, steering),
             te.music_denominator(s, steering, n))
    monkeypatch.setattr(te, "_BEAMFORMING_CHUNK_ELEMS", 3 * G)
    monkeypatch.setattr(te, "_MUSIC_CHUNK_ELEMS", 3 * G * A)
    chunked = (te.beamforming_spectrum(s, steering),
               te.music_denominator(s, steering, n))
    for got, want in zip(chunked, whole):
        assert got.shape == want.shape == (40, G)
        scale = want.abs().amax(dim=-1, keepdim=True)
        assert ((got - want).abs() / scale).max() < 1e-6


def test_angle_confidence_matches_at_the_ura():
    s = _ura_signatures(4)
    rng = np.random.default_rng(5)
    az = rng.uniform(-60, 60, s.shape[0]).astype(np.float32)
    el = rng.uniform(-30, 30, s.shape[0]).astype(np.float32)
    for e in (el, None):
        want = np.asarray(jconf.angle_confidence(
            jnp.asarray(s), jnp.asarray(az), URA,
            None if e is None else jnp.asarray(e)))
        got = to_np(tconf.angle_confidence(
            torch.tensor(s), torch.tensor(az), TCFG.radar,
            None if e is None else torch.tensor(e)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- end to end -------------------------------------------------------------------

def test_joint_az_el_recovery_through_the_port():
    """tests/test_elevation.py:48-95 on the port's plain versions: three
    planted (range, az, el) scatterers -> URA synthesis -> RDS ->
    detection -> joint estimation; each within 2 deg in azimuth and 3 deg
    in elevation."""
    truth = [(20.0, 0.30, 0.15), (35.0, -0.40, -0.20), (48.0, 0.05, 0.08)]
    S = 16
    pad = lambda v: np.pad(np.asarray(v, np.float32), (0, S - 3))  # noqa: E731
    batch = ScattererBatch(
        range_m=torch.tensor(pad([t[0] for t in truth]))[None],
        azimuth_rad=torch.tensor(pad([t[1] for t in truth]))[None],
        rcs_db=torch.tensor(pad([15.0] * 3))[None],
        vr=torch.zeros(1, S), valid=(torch.arange(S) < 3)[None],
        elevation_rad=torch.tensor(pad([t[2] for t in truth]))[None])
    sig = tsynth.synthesize_frame(batch, TCFG.radar,
                                  torch.zeros(1, dtype=torch.int32))
    assert sig.shape == (1, 32, 32, 400)
    rds = range_doppler_spectrum(sig, TCFG.radar, doppler_window="hann")
    det = detect_peaks(rds, TCFG.radar, TCFG.detection)
    sigs = extract_spatial_signatures(rds, det)
    az, el, _ = te.estimate_angles_2d(sigs, TCFG.radar, TCFG.aoa)
    ok = to_np(det.valid)[0]
    got = {}
    for r, a, e in zip(to_np(det.range_m)[0][ok], to_np(az)[0][ok],
                       to_np(el)[0][ok]):
        key = min(truth, key=lambda t: abs(t[0] - r))
        got.setdefault(key, (a, e))
    for t in truth:
        assert t in got, f"target at {t[0]} m not detected"
        a, e = got[t]
        assert abs(a - np.degrees(t[1])) < 2.0, (t, a)
        assert abs(e - np.degrees(t[2])) < 3.0, (t, e)


def test_onepass_ura_driver_matches_reference_composition(monkeypatch):
    F = 2
    ref_cfg = jcfg.PipelineConfig(
        radar=jcfg.RadarConfig(noise_power=0.0, num_chirps=16,
                               num_antennas=4, num_antennas_el=2,
                               bandwidth=250e6, chirp_duration=12.8e-6),
        detection=jcfg.DetectionConfig(cfar_train_cells=4, guard_cells=1,
                                       cfar_offset_db=12.0,
                                       max_detections=16),
        aoa=jcfg.AoAConfig(search_resolution_deg=2.0, el_min_deg=-30.0,
                           el_max_deg=30.0, el_resolution_deg=3.0,
                           confidence_threshold=0.5, max_targets=16),
        velocity=jcfg.VelocityConfig(z_velocity_weight=1.0),
        max_scatterers=16, fft_mode="fused", synth_in_kernel=True)
    cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    assert tframe._phase_a_route(cfg) == "one_pass"
    jbatch, _ = jsyn.constant_motion_scene_3d(
        0, num_frames=F, dt=0.1, v_body=(6.0, -0.5, 0.5), yaw_rate=0.05,
        scene=jsyn.SceneConfig(num_points=16, max_scatterers=16,
                               max_range=60.0), z_span=4.0)
    kernel = jfe.scatterer_frontend_split
    monkeypatch.setattr(jfe, "scatterer_frontend_split",
                        lambda *a, **k: jax.block_until_ready(
                            kernel(*a, **k)))
    with pltpu.force_tpu_interpret_mode():
        _, det, sigs = jframe._onepass_frontend(
            jbatch, jnp.arange(F, dtype=jnp.int32), ref_cfg)
        jax.block_until_ready(sigs)
    feats = jax.jit(jax.vmap(
        lambda d, s: jframe._aoa_features(d, s, ref_cfg)))(det, sigs)
    ref = jax.jit(lambda f: jframe._sequence_from_features(
        f, ref_cfg, True))(feats)
    batch = scatterer_batch_from_numpy(_fields(jbatch), "cpu")
    tfeats = tframe.sequence_features_scatterers_fused(
        batch, torch.Generator(), cfg)
    got = tframe.process_sequence_batched(batch, torch.Generator(), cfg)
    assert to_np(got.num_detections).min() > 5
    np.testing.assert_array_equal(to_np(tfeats[0].valid),
                                  np.asarray(feats[0].valid))
    keep = np.asarray(feats[2])
    np.testing.assert_allclose(to_np(tfeats[6])[keep],
                               np.asarray(feats[6])[keep], rtol=0,
                               atol=1e-3)
    assert np.abs(np.asarray(feats[6])[keep]).max() > 3.0
    for name in ("num_detections", "num_reliable", "num_associations",
                 "target_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  np.asarray(ref.motion.success))
    valid = np.asarray(ref.target_valid)
    np.testing.assert_allclose(to_np(got.target_xy)[valid],
                               np.asarray(ref.target_xy)[valid], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(to_np(got.motion.velocity),
                               np.asarray(ref.motion.velocity), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(to_np(got.pose), np.asarray(ref.pose),
                               rtol=0, atol=1e-4)
