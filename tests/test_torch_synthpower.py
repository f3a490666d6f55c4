"""The port's three-dispatch synthesis kernels (radar_slam_tpu_torch/
ops/synthpower.py: K6 noise_cube, K4 scatterer_power, K5
scatterer_signatures), the Box-Muller transform of its Gaussian generator,
and the dense-factor one-pass front end (ops/frontend.py, K3) against the
JAX reference on the CPU.

Inputs and oracle: the synthesis factors are made once by the reference
(its carrier phase rounds differently between programs, test_synthpower.py
:4-11) and handed to both packages as numpy.  The reference's Pallas
kernels run in interpret mode, whose PRNG is degenerate, so JAX-vs-port
comparisons are at sigma = 0; the port's own kernels are compared at the
production sigma against explicit cubes built from the same Philox noise
(``noise_cube_reference``).  Tolerances, with their reasons:

- K4 power map 1e-4 of its maximum against the reference (its setup in
  test_power_matches_explicit_cube: float32 products in another order),
  1e-5 against the port's own explicit cube (the same float32 formulation);
- K5 valid-slot signatures within 2e-4 (unit-power vectors; the reference's
  test_signatures_match_explicit_cube);
- K3 as K1 (test_torch_frontend.py): power map 1e-5 of its maximum,
  detection sets equal up to one borderline CFAR flip, signatures 2e-4;
  against the port's split K1 the Z planes to 1e-5 of their maximum too
  (the dense and the split factors round the ~400-cycle beat phase
  differently, ~5e-6 of max |Z| measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.ops import synthpower_pallas as jsp
from radar_slam_tpu.ops.windows import window_freq_taps as jtaps
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu.signal import rds as jrds
from radar_slam_tpu.signal.synth import synthesis_factors as jfactors
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops import synthpower as sp
from radar_slam_tpu_torch.ops.noise import philox4x32, standard_normals
from radar_slam_tpu_torch.ops.windows import window_freq_taps
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal.rds import (detection_signatures,
                                             range_dft_matrix, rds_power)
from radar_slam_tpu_torch.signal.synth import (fast_time_base,
                                               synthesis_factors_split)

F = 2
SEEDS = np.array([29, -5], dtype=np.int32)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def factors():
    """The bench scene's dense factors, made by the reference, as numpy;
    the mix and the production sigma."""
    cfg = bench_config()
    jbatch, fields, _ = scene_fields(F)
    e_ac, e_fast = jax.vmap(lambda s: jfactors(s, cfg.radar))(jbatch)
    S = cfg.radar.samples_per_chirp
    mix = np.asarray(jrds._mix_vector(cfg.radar, cfg.window, "baseband", S))
    return (cfg, fields, np.asarray(e_ac), np.asarray(e_fast), mix,
            float(cfg.radar.noise_power) ** 0.5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _explicit_cube(e_ac, e_fast, sigma, impl="fast"):
    """e_ac^T e_fast + sigma (K6's plain noise planes) [F, A, C, S]."""
    x = torch.matmul(_t(e_ac).transpose(-1, -2), _t(e_fast))
    nz = sp.noise_cube_reference(_t(SEEDS), x.shape[-2], x.shape[-1], impl)
    return (x + sigma * nz).reshape(F, 8, 32, -1)


# ---- Box-Muller (ops/noise.py) ----------------------------------------------

def test_box_muller_philox_word_mapping():
    """u1 = (w0 >> 8) 2^-24 + 2^-25, u2 = (w1 >> 8) 2^-24 of block 0, the
    planes r cos(2 pi u2) and r sin(2 pi u2), r = sqrt(-2 ln u1): the
    port's planes against float64 numpy from the same Philox words (float32
    rounding of a phase up to 2 pi and of r up to ~5.6: 1e-5)."""
    seeds = torch.tensor([0, 12345, -7], dtype=torch.int32)
    rows, cols = 3, 41
    gr, gi = standard_normals(seeds, rows, cols, "box_muller")
    idx = torch.arange(rows * cols, dtype=torch.int64)[None, :]
    key = (seeds.to(torch.int64) & 0xFFFFFFFF)[:, None]
    w0, w1, _, _ = philox4x32((idx, 0, 0, 0), (key, 0))
    u1 = (to_np(w0 >> 8).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25)
    u2 = to_np(w1 >> 8).astype(np.float64) * 2.0 ** -24
    r = np.sqrt(-2.0 * np.log(u1))
    np.testing.assert_allclose(to_np(gr).reshape(3, -1),
                               r * np.cos(2 * np.pi * u2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(gi).reshape(3, -1),
                               r * np.sin(2 * np.pi * u2), rtol=0, atol=1e-5)
    # "fast" takes its Rayleigh radius from the same word w0.
    fr, fi = standard_normals(seeds, rows, cols, "fast")
    np.testing.assert_allclose(to_np(torch.hypot(fr, fi)),
                               to_np(torch.hypot(gr, gi)), rtol=1e-5)


def test_box_muller_statistics():
    """1.6M samples: zero mean, unit variance, no excess kurtosis, normal
    by KS, independent planes, unclipped tails beyond 4 sigma at the normal
    rate; distinct seeds give uncorrelated planes."""
    seeds = torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, 7, 99],
                         dtype=torch.int32)
    gr, gi = (to_np(x).astype(np.float64)
              for x in standard_normals(seeds, 256, 400, "box_muller"))
    x = np.concatenate([gr.ravel(), gi.ravel()])
    assert np.isfinite(x).all()
    assert abs(x.mean()) < 5e-3 and abs(x.var() - 1.0) < 5e-3
    assert abs(stats.kurtosis(x)) < 0.02
    assert stats.kstest(gr.ravel(), "norm").pvalue > 1e-3
    assert abs(np.mean(gr.ravel() * gi.ravel())) < 5e-3
    n4 = int(np.sum(np.abs(x) > 4.0))
    expect = 2 * stats.norm.sf(4.0) * x.size
    assert 0.5 * expect < n4 < 1.6 * expect
    assert abs(np.corrcoef(gr[0].ravel(), gr[1].ravel())[0, 1]) < 0.01


@pytest.mark.parametrize("impl", ["fast", "box_muller"])
def test_noise_cube_is_the_generator(impl):
    """K6's plain path is exactly standard_normals' planes as complex64;
    the wrapper runs it on a CPU tensor and launches nothing."""
    before = sp.noise_cube.launches
    nz = sp.noise_cube(_t(SEEDS), 24, 40, impl)
    assert sp.noise_cube.launches == before
    gr, gi = standard_normals(_t(SEEDS), 24, 40, impl)
    assert nz.dtype == torch.complex64 and nz.shape == (F, 24, 40)
    np.testing.assert_array_equal(to_np(nz.real), to_np(gr))
    np.testing.assert_array_equal(to_np(nz.imag), to_np(gi))


# ---- K4 -------------------------------------------------------------------

def test_power_matches_reference_interpret_sigma0(factors):
    """The reference's setup of test_power_matches_explicit_cube, all
    precisions "highest", at sigma = 0."""
    cfg, _, e_ac, e_fast, mix, _ = factors
    C = cfg.radar.num_chirps
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.scatterer_power(
            jnp.asarray(e_ac), jnp.asarray(e_fast), jnp.asarray(SEEDS),
            jnp.asarray(mix), C, 0.0, doppler_window=cfg.doppler_window,
            synth_precision="highest", precision_name="highest",
            doppler_precision="highest"))
    before = sp.scatterer_power.launches
    got = to_np(sp.scatterer_power(_t(e_ac), _t(e_fast), _t(SEEDS),
                                   _t(mix), C, 0.0,
                                   doppler_window=cfg.doppler_window,
                                   synth_precision="highest",
                                   precision_name="highest",
                                   doppler_precision="highest"))
    assert sp.scatterer_power.launches == before
    assert got.shape == want.shape == (F, 400, C)
    assert rel(got, want) < 1e-4


def test_power_matches_explicit_cube_with_noise(factors):
    """At the production sigma: the port's K4 (plain) equals rds_power on
    the explicit cube from K6's plain noise, and the reference's XLA
    rds_power on that same cube."""
    cfg, _, e_ac, e_fast, mix, sigma = factors
    C = cfg.radar.num_chirps
    got = to_np(sp.scatterer_power(_t(e_ac), _t(e_fast), _t(SEEDS), _t(mix),
                                   C, sigma,
                                   doppler_window=cfg.doppler_window,
                                   noise_impl=cfg.noise_impl))
    cube = _explicit_cube(e_ac, e_fast, sigma, cfg.noise_impl)
    want = to_np(rds_power(cube, cfg.radar, window=cfg.window,
                           doppler_window=cfg.doppler_window))
    assert rel(got, want) < 1e-5
    jwant = np.asarray(jax.vmap(lambda s: jrds.rds_power(
        s, cfg.radar, window=cfg.window, doppler_window=cfg.doppler_window,
        mode="xla"))(jnp.asarray(to_np(cube))))
    assert rel(got, jwant) < 1e-5
    # The noise is on: the map differs from the noiseless one.
    clean = to_np(sp.scatterer_power(_t(e_ac), _t(e_fast), _t(SEEDS),
                                     _t(mix), C, 0.0,
                                     doppler_window=cfg.doppler_window))
    assert rel(got, clean) > 1e-6


# ---- K5 -------------------------------------------------------------------

def _detections(cfg, p_lin):
    det = jax.vmap(lambda p: jdet.detect_peaks_from_power(
        p, cfg.radar, cfg.detection))(jnp.asarray(p_lin))
    return (np.asarray(det.range_bin), np.asarray(det.doppler_bin),
            np.asarray(det.valid))


def test_signatures_match_reference_interpret_sigma0(factors):
    cfg, _, e_ac, e_fast, mix, _ = factors
    C = cfg.radar.num_chirps
    p = to_np(sp.scatterer_power(_t(e_ac), _t(e_fast), _t(SEEDS), _t(mix),
                                 C, 0.0, doppler_window=cfg.doppler_window))
    rb, db, valid = _detections(cfg, p)
    assert valid.sum() > 20 * F
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.scatterer_signatures(
            jnp.asarray(e_ac), jnp.asarray(e_fast), jnp.asarray(SEEDS),
            jnp.asarray(rb), jnp.asarray(db), jnp.asarray(mix), C, 0.0,
            doppler_window=cfg.doppler_window, synth_precision="highest",
            sig_precision="highest"))
    before = sp.scatterer_signatures.launches
    got = to_np(sp.scatterer_signatures(
        _t(e_ac), _t(e_fast), _t(SEEDS), _t(rb), _t(db), _t(mix), C, 0.0,
        doppler_window=cfg.doppler_window, synth_precision="highest",
        sig_precision="highest"))
    assert sp.scatterer_signatures.launches == before
    assert got.shape == want.shape == (F, 64, 8)
    assert got.dtype == np.complex64
    assert np.abs(got - want)[valid].max() < 2e-4


def test_signatures_match_explicit_cube_with_noise(factors):
    cfg, _, e_ac, e_fast, mix, sigma = factors
    C = cfg.radar.num_chirps
    p = sp.scatterer_power(_t(e_ac), _t(e_fast), _t(SEEDS), _t(mix), C,
                           sigma, doppler_window=cfg.doppler_window,
                           noise_impl=cfg.noise_impl)
    det = tdet.detect_peaks_from_power(p, cfg.radar, cfg.detection)
    got = to_np(sp.scatterer_signatures(
        _t(e_ac), _t(e_fast), _t(SEEDS), det.range_bin, det.doppler_bin,
        _t(mix), C, sigma, doppler_window=cfg.doppler_window,
        noise_impl=cfg.noise_impl))
    cube = _explicit_cube(e_ac, e_fast, sigma, cfg.noise_impl)
    want = to_np(detection_signatures(cube, det.range_bin, det.doppler_bin,
                                      cfg.radar, window=cfg.window,
                                      doppler_window=cfg.doppler_window))
    valid = to_np(det.valid)
    assert valid.sum() > 20 * F
    assert np.abs(got - want)[valid].max() < 2e-4
    power = np.sum(np.abs(got[valid]) ** 2, axis=-1)
    np.testing.assert_allclose(power, 1.0, rtol=1e-5)


# ---- K3 -------------------------------------------------------------------

def _frontend_kwargs(cfg, lo, hi, taps):
    d = cfg.detection
    return dict(train=d.cfar_train_cells, guard=d.guard_cells,
                neighborhood=d.neighborhood, offset_db=d.cfar_offset_db,
                threshold_db=d.threshold_db, min_range_bin=lo,
                max_range_bin=hi, doppler_window=cfg.doppler_window,
                doppler_precision=cfg.synth_doppler_precision,
                doppler_layout=cfg.synth_doppler_layout,
                noise_impl=cfg.noise_impl, noise_domain=cfg.noise_domain,
                noise_taps=taps, topk_mode=cfg.frontend_topk)


def _port_dense(cfg, e_ac, e_fast, mix, sigma, **over):
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    lo, hi = tdet.range_gate_bin_interval(cfg.radar, S, cfg.detection)
    kw = _frontend_kwargs(cfg, lo, hi, window_freq_taps(cfg.window))
    kw.update(over)
    return tuple(map(to_np, fe.scatterer_frontend(
        _t(e_ac), _t(e_fast), _t(SEEDS), _t(mix), C, sigma,
        cfg.detection.max_detections, precision_name=cfg.power_precision,
        **kw)))


def _detection_sets_match(a, b):
    """K1's tolerances on (p, rb, db, vals, sigs) tuples: the power map to
    1e-5 of its maximum, sets equal up to one flip, signatures 2e-4."""
    (p1, rb1, db1, v1, s1), (p2, rb2, db2, v2, s2) = a, b
    assert rel(p2, p1) < 1e-5
    val1, val2 = v1 > -np.inf, v2 > -np.inf
    set1 = {(f, int(r), int(d)) for f in range(F)
            for r, d, ok in zip(rb1[f], db1[f], val1[f]) if ok}
    set2 = {(f, int(r), int(d)) for f in range(F)
            for r, d, ok in zip(rb2[f], db2[f], val2[f]) if ok}
    assert len(set1) > 20 * F
    assert len(set1 ^ set2) <= 1, (len(set1 ^ set2), len(set1))
    both = val1 & val2 & (rb1 == rb2) & (db1 == db2)
    assert both.sum() >= 0.95 * val1.sum()
    assert np.abs(s1[both] - s2[both]).max() < 2e-4


def test_dense_frontend_matches_reference_interpret_sigma0(factors):
    """The reference's scatterer_frontend in interpret mode with the
    production knobs (range-frequency noise, the Hann window's taps, the
    "fast" transform) at sigma = 0."""
    cfg, _, e_ac, e_fast, mix, _ = factors
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    lo, hi = jdet.range_gate_bin_interval(cfg.radar, S, cfg.detection)
    with pltpu.force_tpu_interpret_mode():
        want = tuple(map(np.asarray, jfe.scatterer_frontend(
            jnp.asarray(e_ac), jnp.asarray(e_fast), jnp.asarray(SEEDS),
            jnp.asarray(mix), C, 0.0, cfg.detection.max_detections,
            precision_name=cfg.power_precision,
            **_frontend_kwargs(cfg, lo, hi, jtaps(cfg.window)))))
    before = fe.frontend_kernel_dense.launches
    got = _port_dense(cfg, e_ac, e_fast, mix, 0.0)
    assert fe.frontend_kernel_dense.launches == before
    assert got[0].shape == want[0].shape == (F, S, C)
    _detection_sets_match(want, got)
    assert np.array_equal(np.isneginf(want[3]), np.isneginf(got[3]))


def test_dense_frontend_matches_split_with_noise(factors):
    """At the production sigma K3 (dense factors) and K1 (split tables of
    the same scene) draw the same noise: the same detections."""
    cfg, fields, e_ac, e_fast, mix, sigma = factors
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    dense = _port_dense(cfg, e_ac, e_fast, mix, sigma)
    split = synthesis_factors_split(scatterer_batch_from_numpy(fields, "cpu"),
                                    cfg.radar)
    lo, hi = tdet.range_gate_bin_interval(cfg.radar, S, cfg.detection)
    kw = _frontend_kwargs(cfg, lo, hi, window_freq_taps(cfg.window))
    for name in ("doppler_precision", "doppler_layout"):
        kw.pop(name)
    want = tuple(map(to_np, fe.scatterer_frontend_split(
        split.ant, split.dopp, split.coarse, split.fine, split.tau,
        fast_time_base(cfg.radar, device="cpu"), _t(SEEDS), _t(mix), C, sigma,
        cfg.detection.max_detections, **kw)))
    _detection_sets_match(want, dense)
    # The noise is on: the map differs from the noiseless one.
    assert rel(dense[0], _port_dense(cfg, e_ac, e_fast, mix, 0.0)[0]) > 1e-6


def test_dense_frontend_shares_k1s_body(factors):
    """K3's and K1's plain versions run one body: on factor planes that
    are K1's recomposed split tables, K3's outputs are K1's, bit for bit."""
    cfg, fields, _, _, mix, sigma = factors
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    split = synthesis_factors_split(scatterer_batch_from_numpy(fields, "cpu"),
                                    cfg.radar)
    e_at = (split.dopp.transpose(1, 2)[:, None]
            * split.ant.transpose(1, 2)[:, :, None]).reshape(F, 8 * C, -1)
    t = fast_time_base(cfg.radar, device="cpu")
    e_fast = (split.coarse[..., :, None] * split.fine[..., None, :]).reshape(
        F, split.coarse.shape[1], -1)[..., :S]
    e_fast = e_fast * (t[None, None, :] >= split.tau[..., None]).float()
    w_rng = range_dft_matrix(S, _t(mix), True)
    w_dop_t = fe.doppler_constant(C, cfg.doppler_window, "cpu")
    prm = fe.FrontendParams(
        sigma=sigma, noise_taps=window_freq_taps(cfg.window),
        echo_upper=None, dc_removal=True, train=8, guard=2, neighborhood=3,
        offset_db=12.0, threshold_db=-25.0, min_range_bin=1,
        max_range_bin=S - 1, noise_domain="range_freq", noise_impl="fast",
        cfar_impl="matmul", clutter_offset_db=6.0)
    k1 = fe.scatterer_frontend_split_reference(
        split.ant, split.dopp, split.coarse, split.fine, split.tau, t,
        _t(SEEDS), w_rng, w_dop_t, prm)
    k3 = fe.frontend_kernel_dense(e_at.transpose(1, 2).contiguous(),
                                  e_fast.contiguous(), _t(SEEDS), _t(mix),
                                  w_dop_t, prm, C)
    for a, b in zip(k1, k3):
        np.testing.assert_array_equal(to_np(a), to_np(b))


# ---- wrappers ---------------------------------------------------------------

def test_wrappers_check_their_inputs(factors):
    cfg, _, e_ac, e_fast, mix, sigma = factors
    C = cfg.radar.num_chirps
    args = [_t(e_ac), _t(e_fast), _t(SEEDS), _t(mix)]
    with pytest.raises(ValueError):
        sp.scatterer_power(args[0][..., :-1], *args[1:], C, sigma)
    with pytest.raises(ValueError):
        sp.scatterer_power(args[0], args[1][:, :-1], *args[2:], C, sigma)
    with pytest.raises(TypeError):
        sp.scatterer_power(args[0].to(torch.complex128), *args[1:], C, sigma)
    with pytest.raises(ValueError):
        sp.scatterer_power(*args, C, sigma, noise_impl="ziggurat")
    with pytest.raises(ValueError):
        sp.scatterer_power(*args, C, sigma, doppler_layout="diagonal")
    with pytest.raises(ValueError):
        sp.scatterer_power(*args, C, sigma, precision_name="bf8")
    rb = torch.zeros(F, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        sp.scatterer_signatures(*args[:3], rb, rb[:, :-1], args[3], C, sigma)
    with pytest.raises(ValueError):
        sp.noise_cube(_t(SEEDS)[None], 4, 4)
    with pytest.raises(ValueError):
        sp.noise_cube(_t(SEEDS), 4, 4, "ziggurat")


@pytest.mark.parametrize("knob,value,exc", [
    ("noise_domain", "freq", ValueError),
    ("noise_impl", "ziggurat", ValueError),
    ("cfar_impl", "fft", ValueError),
    ("clutter", torch.zeros(F, 32, 400), ValueError),
    ("noise_taps", (), ValueError),
])
def test_dense_frontend_unported_knobs_raise(factors, knob, value, exc):
    """K3 takes every knob value of the reference's wrapper (K1'); unknown
    names and a clutter map in the wrong layout raise."""
    cfg, _, e_ac, e_fast, mix, _ = factors
    with pytest.raises(exc):
        _port_dense(cfg, e_ac, e_fast, mix, 0.0, **{knob: value})


def test_precision_names_select_nothing(factors):
    """The reference's precision and layout names are accepted and leave
    the float32 result as it is."""
    cfg, _, e_ac, e_fast, mix, _ = factors
    C = cfg.radar.num_chirps
    args = (_t(e_ac), _t(e_fast), _t(SEEDS), _t(mix), C, 0.0)
    base = to_np(sp.scatterer_power(*args))
    for kw in (dict(synth_precision="highest", precision_name="high",
                    doppler_precision="default", doppler_layout="wide"),
               dict(synth_precision="default", precision_name="highest",
                    doppler_precision="highest", doppler_layout="loop")):
        np.testing.assert_array_equal(to_np(sp.scatterer_power(*args, **kw)),
                                      base)
