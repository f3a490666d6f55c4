"""The factored range DFT of the front-end kernels (``ops/range_dft.py``):
its plain version, in the kernels' stage order, against the dense range
DFT of the port and of the JAX reference.

Tolerances, relative to max |Y|:
- against the DFT evaluated in float64: 1e-6 (an FFT's float32 rounding,
  ~1.3e-7 measured at S = 400, ~log2(S) roundings of each value);
- against ``range_dft_matrix`` (the port's and the reference's constant):
  2e-4, the constant's own error: its phases (2 pi / S) s r reach ~2.5e3
  rad in float32, where an ulp is ~2.4e-4 rad, so each entry carries up to
  ~1.2e-4 rad (7e-5 of max |Y| measured at S = 400).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, to_np

from radar_slam_tpu.signal import rds as jrds
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.ops import range_dft as rd
from radar_slam_tpu_torch.signal import rds as trds

EXACT_TOL = 1e-6
CONSTANT_TOL = 2e-4


def _rows(S, seed=0):
    """Noise rows and tones at non-integer bins, complex64 [24, S]."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((16, S)) + 1j * rng.standard_normal((16, S))
    s = np.arange(S)
    tones = np.exp(2j * np.pi * np.outer(rng.uniform(0, S, 8), s) / S)
    return np.concatenate([noise, 3.0 * tones]).astype(np.complex64)


def _mix(S, domain):
    """The baseband (window) or raw (dechirp x window) mix of a bench
    configuration with S samples per chirp, from the port and the JAX
    package."""
    ref = bench_config()
    ref = dataclasses.replace(ref, radar=dataclasses.replace(
        ref.radar, sampling_rate=(S + 0.5) / ref.radar.chirp_duration))
    assert ref.radar.samples_per_chirp == S
    cfg = config_from_dict(dataclasses.asdict(ref))
    mix_t = trds._mix_vector(cfg.radar, cfg.window, domain, S,
                             device="cpu")
    mix_j = jrds._mix_vector(ref.radar, ref.window, domain, S)
    return mix_t, mix_j


def _exact(x, mix, dc):
    S = x.shape[-1]
    s = np.arange(S, dtype=np.float64)
    w = np.exp(2j * np.pi * np.outer(s, s) / S)
    if dc:
        w[:, 0] = 0
    return (x.astype(np.complex128) * mix.astype(np.complex128)) @ w


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("S", [400, 256, 384, 500])
@pytest.mark.parametrize("dc", [True, False])
@pytest.mark.parametrize("domain", ["baseband", "raw"])
def test_factored_dft_matches_dense(S, dc, domain):
    """The stage order agrees with the float64 DFT to an FFT's rounding,
    and with the port's and the reference's dense constants to theirs."""
    mix_t, mix_j = _mix(S, domain)
    x = _rows(S)
    got = to_np(rd.range_dft_factored_reference(torch.from_numpy(x), mix_t,
                                                dc))
    assert rd.plan(S) is not None
    assert _rel(got, _exact(x, to_np(mix_t), dc)) < EXACT_TOL
    dense_t = x @ to_np(trds.range_dft_matrix(S, mix_t, dc))
    dense_j = x @ np.asarray(jrds.range_dft_matrix(S, jnp.asarray(mix_j),
                                                   dc))
    assert _rel(got, dense_t) < CONSTANT_TOL
    assert _rel(got, dense_j) < CONSTANT_TOL
    if dc:
        assert np.all(got[:, 0] == 0)


def test_prime_length_takes_the_dense_route():
    """S = 401 (prime) has no radix plan: the dense route, which still
    computes the DFT, and the identity input order."""
    S = 401
    assert rd.plan(S) is None
    assert rd.stage_args(S)[0] == 0
    assert torch.equal(rd.input_positions(S, "cpu"),
                       torch.arange(S, dtype=torch.int32))
    mix_t, _ = _mix(S, "baseband")
    x = _rows(S, 1)
    got = to_np(rd.range_dft_factored_reference(torch.from_numpy(x), mix_t,
                                                True))
    assert _rel(got, _exact(x, to_np(mix_t), True)) < EXACT_TOL


@pytest.mark.parametrize("S", [400, 256, 384, 500, 6, 30, 1])
def test_plan_covers_s_and_positions_permute(S):
    """The radices multiply to S, take 4 before 2, and the input positions
    are a permutation of 0..S-1."""
    radices = rd.plan(S)
    assert math.prod(radices) == S
    assert radices.count(2) <= 1
    pos = to_np(rd.input_positions(S, "cpu"))
    assert sorted(pos.tolist()) == list(range(S))


def test_columns_are_the_factored_dft():
    """range_columns_exact (K5's range columns on the card) are columns of
    the transform the stages compute: the stages applied to the unit rows
    give the matrix."""
    S = 400
    mix_t, _ = _mix(S, "raw")
    eye = torch.eye(S, dtype=torch.complex64)
    fac = to_np(rd.range_dft_factored_reference(eye, mix_t, True))
    bins = torch.tensor([[0, 1, 57, 399]])
    cols = to_np(rd.range_columns_exact(S, bins, mix_t, True)[0])
    assert _rel(cols, fac[:, bins[0].numpy()]) < EXACT_TOL
    assert np.all(cols[:, 0] == 0)


def test_twiddles_are_float64_rounded_once():
    S = 400
    k = np.arange(S)
    want = np.exp(2j * np.pi * k / S).astype(np.complex64)
    got = to_np(rd.twiddles(S, "cpu"))
    assert np.abs(got - want).max() <= 2 ** -24
    assert got[S // 4] == 1j and got[S // 2] == -1
