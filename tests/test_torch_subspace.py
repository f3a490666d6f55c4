"""The port's subspace AoA methods (MUSIC, ESPRIT) against the reference's.

Inputs are made with numpy from a seed: random signatures [K, 8] and
steering vectors at random angles with complex noise, the shapes the
pipeline hands the estimators.  Each function of
``radar_slam_tpu/aoa/estimators.py:150-401`` is held against its
counterpart, with and without a leading frame axis (the reference vmaps).

Tolerances: covariances and spectra to float32 rounding, 1e-5 of each
row's maximum; eigenvalues 1e-5 of the largest; eigenvectors, whose phase
is free, as projectors e e^H to 1e-5 (1e-4 for ``eigh``'s near-degenerate
null space, compared as the projector onto the signal eigenvector only);
angles refined by a parabola through spectrum samples 1e-3 deg; ESPRIT's
arcsin 1e-3 deg.  The MUSIC cancellation trap has its own test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, to_np

from radar_slam_tpu.aoa import estimators as je
from radar_slam_tpu.aoa import robust as jrobust
from radar_slam_tpu.core import types as jtypes
from radar_slam_tpu_torch.aoa import estimators as te
from radar_slam_tpu_torch.aoa import robust as trobust
from radar_slam_tpu_torch.core import types as ttypes
from radar_slam_tpu_torch.core.config import config_from_dict

A = 8


def _configs():
    ref = bench_config()
    return ref, config_from_dict(dataclasses.asdict(ref))


def _signatures(seed, n=48, noise=0.3):
    """Half steering vectors at random angles in the search span with
    complex noise, half pure noise (no single tone), complex64 [n, A]."""
    ref, _ = _configs()
    r = ref.radar
    rng = np.random.default_rng(seed)
    az = np.deg2rad(rng.uniform(-55.0, 55.0, n))
    tone = np.exp(2j * np.pi / r.lambda_c * r.spacing
                  * np.sin(az)[:, None] * np.arange(A))
    tone[n // 2:] = 0.0
    amp = rng.uniform(0.5, 2.0, (n, 1))
    w = rng.normal(size=(n, A)) + 1j * rng.normal(size=(n, A))
    return (amp * tone + noise * w).astype(np.complex64)


def _projectors(vecs):
    """e e^H for vectors on the last axis."""
    return vecs[..., :, None] * np.conj(vecs[..., None, :])


def _row_rel(got, want):
    """Largest |got - want| over each row's max |want|."""
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


@pytest.mark.parametrize("fb,load", [(False, 0.0), (True, 0.0),
                                     (True, 1e-3)])
def test_signature_covariances_match(fb, load):
    s = _signatures(0)
    want = np.asarray(je.signature_covariances(jnp.asarray(s), fb, load))
    got = to_np(te.signature_covariances(torch.tensor(s), fb, load))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want)
                               .max())


def test_eigendecompose_descending_and_projectors():
    """Descending eigenvalues to 1e-5 of the largest; the eigenvectors of
    the distinct top eigenvalues as projectors to 1e-4.  The FB covariance
    has rank 2 and a degenerate null space, whose basis is arbitrary."""
    s = _signatures(1)
    R = np.asarray(je.signature_covariances(jnp.asarray(s), True, 1e-3))
    wv, wV = (np.asarray(x) for x in je.eigendecompose(jnp.asarray(R)))
    gv, gV = (to_np(x) for x in te.eigendecompose(torch.tensor(R)))
    assert np.all(np.diff(gv, axis=-1) <= 0)
    np.testing.assert_allclose(gv, wv, rtol=0,
                               atol=1e-5 * np.abs(wv).max())
    for i in range(2):
        np.testing.assert_allclose(_projectors(gV[..., i]),
                                   _projectors(wV[..., i]), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("fb", [False, True])
def test_rank2_signal_eigvecs_match(fb):
    """Ranks exact; each signal eigenvector as a projector to 1e-5.  Rows
    include a zero signature (rank 0) and a conjugate-centrosymmetric one
    (its FB pair colinear: rank 1)."""
    s = _signatures(2)
    s[0] = 0.0
    half = s[1, :A // 2]
    s[1] = np.concatenate([half, np.conj(half[::-1])])
    wE, wr = (np.asarray(x) for x in
              je._rank2_signal_eigvecs(jnp.asarray(s), fb))
    gE, gr = (to_np(x) for x in te._rank2_signal_eigvecs(torch.tensor(s),
                                                          fb))
    np.testing.assert_array_equal(gr, wr)
    assert wr[0] == 0 and (not fb or wr[1] == 1)
    for j in range(2):
        np.testing.assert_allclose(_projectors(gE[:, j]),
                                   _projectors(wE[:, j]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("num_sources", ["one", "two", "mixed"])
def test_music_denominator_and_spectrum_match(fb, num_sources):
    """With a leading frame axis [F, K, A] against the vmapped reference:
    the null spectrum to 1e-5 of each row's maximum, the pseudo-spectrum
    where the null spectrum is not near its clamp (1e-12) likewise."""
    ref, cfg = _configs()
    s = _signatures(3).reshape(2, 24, A)
    m = {"one": np.ones((2, 24), np.int32),
         "two": np.full((2, 24), 2, np.int32),
         "mixed": np.random.default_rng(3).integers(0, 3, (2, 24))
         .astype(np.int32)}[num_sources]
    steer = je.grid_steering_matrix(ref.radar, ref.aoa)
    want = np.asarray(jax.vmap(lambda x, n: je.music_denominator(
        x, steer, n, fb))(jnp.asarray(s), jnp.asarray(m)))
    tsteer = te.grid_steering_matrix(cfg.radar, cfg.aoa, "cpu")
    got = to_np(te.music_denominator(torch.tensor(s), tsteer,
                                     torch.tensor(m), fb))
    assert got.shape == want.shape == (2, 24, ref.aoa.num_grid_points)
    assert _row_rel(got, want) < 1e-5
    spec_w = np.asarray(jax.vmap(lambda x, n: je.music_spectrum(
        x, steer, n, fb))(jnp.asarray(s), jnp.asarray(m)))
    spec_g = to_np(te.music_spectrum(torch.tensor(s), tsteer,
                                     torch.tensor(m), fb))
    away = want > 1e-6
    np.testing.assert_allclose(spec_g[away], spec_w[away], rtol=1e-4)


def test_music_residual_form_at_the_nulls():
    """The cancellation trap (reference estimators.py:264-291).  At a
    source's null the value is all cancellation: the difference form
    |a|^2 - sum |e^H a|^2 loses ~1e-7 A absolutely.

    - Signatures that ARE steering vectors of the grid (rows of the
      steering matrix): the exact null is 0.  The residual form stays at
      float32 rounding of unit vectors (< 1e-10 = 1.25e-11 A, as the
      reference's); the difference form is >= 100x that on most rows.
    - Sources 1e-3 deg off grid angles (nulls 4e-9 .. 1.3e-7): the
      residual form is within 2e-3 relative of a float64 evaluation on the
      same complex64 inputs and of the reference's residual form, at the
      same steering matrix; the difference form is off by more than 100 %
      there.  Relative agreement at the nulls is bounded by the float32
      rounding of the unit vector (relative ~ 2 ulp |a| / |resid|): the
      reference itself is 2.5e-4 from the float64 value there, and a
      1e-5 bound is reachable only away from the nulls (the test above)."""
    ref, cfg = _configs()
    r = ref.radar
    steer = np.asarray(je.grid_steering_matrix(ref.radar, ref.aoa))
    tsteer = torch.tensor(steer)
    grid = np.asarray(je.azimuth_grid_deg(ref.aoa)).astype(np.float64)
    gi = np.arange(3, ref.aoa.num_grid_points - 3, 4)
    rows = np.arange(len(gi))

    def forms(s):
        got = to_np(te.music_denominator(torch.tensor(s), tsteer, 1,
                                         False))[rows, gi]
        want = np.asarray(je.music_denominator(jnp.asarray(s),
                                               jnp.asarray(steer), 1,
                                               False))[rows, gi]
        u = s / np.linalg.norm(s, axis=1, keepdims=True).astype(np.float32)
        diff = (np.float32(A) - np.abs(np.sum(np.conj(u) * steer[gi], 1))
                ** 2).astype(np.float32)
        return got, want, diff

    got, want, diff = forms(steer[gi].copy())
    assert np.all(got < 1e-10) and np.all(want < 1e-10)
    assert np.mean(np.abs(diff) >= 1e-8) > 0.5, diff

    th = np.deg2rad(grid[gi] + 1e-3)
    s64 = np.exp(2j * np.pi / r.lambda_c * r.spacing * np.sin(th)[:, None]
                 * np.arange(A))
    s = s64.astype(np.complex64)
    got, want, diff = forms(s)
    u = s.astype(np.complex128)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    a = steer[gi].astype(np.complex128)
    exact = np.sum(np.abs(a - np.sum(np.conj(u) * a, 1)[:, None] * u) ** 2,
                   axis=1)
    assert 1e-9 < exact.min() and exact.max() < 1e-6, exact
    np.testing.assert_allclose(got, exact, rtol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert np.max(np.abs(diff - exact) / exact) > 1.0


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("refine", [True, False])
def test_estimate_music_matches(fb, refine):
    """Angles to 1e-3 deg (refined on -denom; unrefined: the grid bin of
    the clamped pseudo-spectrum's maximum, to 1e-5 deg, the two grids'
    float32 rounding) and the returned
    pseudo-spectra where the null spectrum is above 1e-6."""
    ref, cfg = _configs()
    s = _signatures(4)
    wa, ws = je.estimate_music(jnp.asarray(s), ref.radar, ref.aoa, 1,
                               refine, fb)
    ga, gs = te.estimate_music(torch.tensor(s), cfg.radar, cfg.aoa, 1,
                               refine, fb)
    np.testing.assert_allclose(to_np(ga), np.asarray(wa), rtol=0,
                               atol=1e-3 if refine else 1e-5)
    wd = np.asarray(je.music_denominator(
        jnp.asarray(s), je.grid_steering_matrix(ref.radar, ref.aoa), 1, fb))
    np.testing.assert_allclose(to_np(gs)[wd > 1e-6],
                               np.asarray(ws)[wd > 1e-6], rtol=1e-4)


@pytest.mark.parametrize("max_lag", [1, 3, 7])
def test_multilag_slope_matches(max_lag):
    """The slope to 1e-5 rad, with a leading frame axis; the rows include
    steep tones whose higher lags wrap, so the 2 pi branch (round half to
    even) is exercised."""
    s = _signatures(5).reshape(2, 24, A)
    want = np.asarray(jax.vmap(lambda x: je._multilag_slope(x, max_lag))(
        jnp.asarray(s)))
    got = to_np(te._multilag_slope(torch.tensor(s), max_lag))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("weighted", [True, False])
def test_estimate_esprit_matches(weighted):
    ref, cfg = _configs()
    s = _signatures(6)
    want = np.asarray(je.estimate_esprit(jnp.asarray(s), ref.radar,
                                         weighted))
    got = to_np(te.estimate_esprit(torch.tensor(s), cfg.radar, weighted))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("method", ["beamforming", "music", "esprit"])
def test_estimate_angles_2d_dispatch_matches(method):
    """The dispatch reads ``aoa.music_fb`` / ``aoa.esprit_weighted`` (both
    settings of each) and the MDL model order; elevation is zero on a ULA
    and ESPRIT returns no spectra."""
    ref0, _ = _configs()
    s = _signatures(7)
    n = np.random.default_rng(7).integers(1, 3, 48).astype(np.int32)
    for flag in (True, False):
        ref = dataclasses.replace(ref0, aoa=dataclasses.replace(
            ref0.aoa, music_fb=flag, esprit_weighted=flag))
        cfg = config_from_dict(dataclasses.asdict(ref))
        wa, we, wsp = je.estimate_angles_2d(jnp.asarray(s), ref.radar,
                                            ref.aoa, method,
                                            jnp.asarray(n))
        ga, ge, gsp = te.estimate_angles_2d(torch.tensor(s), cfg.radar,
                                            cfg.aoa, method,
                                            torch.tensor(n))
        np.testing.assert_allclose(to_np(ga), np.asarray(wa), rtol=0,
                                   atol=1e-3)
        assert not to_np(ge).any() and not np.asarray(we).any()
        assert (gsp is None) == (wsp is None) == (method == "esprit")


@pytest.mark.parametrize("method", ["music", "esprit", "beamforming"])
def test_process_targets_matches_reference(method):
    """``aoa/robust.py:process_targets`` (the basic stage, MUSIC by
    default) on one frame's RDS [A, R, D] with 12 detections, 4 of them
    invalid: selections exact, angles 1e-3 deg, confidences 1e-5."""
    ref, cfg = _configs()
    rng = np.random.default_rng(9)
    R, D, K = 40, cfg.radar.num_chirps, 12
    rds = (rng.normal(size=(A, R, D)) + 1j * rng.normal(size=(A, R, D))
           ).astype(np.complex64)
    rb = rng.integers(0, R, K).astype(np.int32)
    db = rng.integers(0, D, K).astype(np.int32)
    tone = np.exp(1j * np.arange(A) * rng.uniform(-2.5, 2.5, K)[:, None])
    rds[:, rb, db] += (4.0 * tone.T).astype(np.complex64)
    cols = dict(range_bin=rb, doppler_bin=db,
                range_m=rng.uniform(5, 50, K).astype(np.float32),
                doppler_hz=rng.normal(size=K).astype(np.float32),
                vr_mps=rng.normal(size=K).astype(np.float32),
                power_db=rng.uniform(10, 30, K).astype(np.float32),
                valid=np.arange(K) < 8)
    kw = {} if method == "music" else {"method": method}
    want = jrobust.process_targets(
        jnp.asarray(rds), jtypes.Detections(
            **{k: jnp.asarray(v) for k, v in cols.items()}),
        ref.radar, ref.aoa, **kw)
    got = trobust.process_targets(
        torch.tensor(rds[None]), ttypes.Detections(
            **{k: torch.tensor(v[None]) for k, v in cols.items()}),
        cfg.radar, cfg.aoa, **kw)
    for name in ("num_sources", "is_multipath", "is_reliable", "valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name))[0],
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(np.rad2deg(to_np(got.azimuth_rad)[0]),
                               np.rad2deg(np.asarray(want.azimuth_rad)),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(to_np(got.confidence)[0],
                               np.asarray(want.confidence), rtol=0,
                               atol=1e-5)
