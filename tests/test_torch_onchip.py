"""The on-chip cube kernel's shape routes and the plain forms of K5 and K7
in the kernels' own order, against the JAX reference on the CPU.

- Limits: ``cube_onchip_limits`` (K1' and K3 in the time domain, K4, K5,
  K7) takes C up to 256 chirps, a cluster of ceil(C / 32) blocks per
  antenna beyond 32 ("cluster_rows"); ``_check_launch`` takes A*C rows
  beyond one block's shared memory in the range-frequency domain by
  groups of antennas ("tiled_rows"), A = 16 with C = 64 included, with
  the byte counts of ``csrc/frontend.cu`` (223,488 at A = 8, C = 64;
  370,944 at A = 16).  Each returns the route the kernel takes.
- K5's kernel order (``scatterer_signatures_factored_reference``: the
  factored range FFT rows, the gather at r_k, row d_k of K4's Doppler
  constant) against the reference's ``scatterer_signatures`` in interpret
  mode at sigma = 0 within 2e-4 on unit-power signatures (the reference's
  float32 range columns carry phase errors up to ~1e-4 rad), and against
  ``signatures_from_columns`` on the exact DFT's columns within 1e-5 (one
  transform, float32 sums in two orders); at C = 32 and 64, zero
  signatures staying zero.
- K7's kernel order (``rds_power_factored_reference``) against the
  reference's ``rds_power_reference`` (power_pallas.py:188, HIGHEST)
  within 1e-4 of the map's maximum: the reference's float32 range constant
  sits ~3e-5 of the maximum from the exact DFT on random cubes (measured
  2.6e-5) and ~2e-6 on the bench scene; against the float64 DFT within
  2e-6.
- K8's kernel order (``rds_fused_factored_reference``: the factored range
  FFT rows, then K7's Doppler constant, complex) against the reference's
  ``rds_fused`` in interpret mode at C = 32 and 64 within 2e-4 of max |rds|
  (the reference's float32 range constant: ~7e-5 of the maximum from the
  exact DFT on random cubes, as Z in tests/test_torch_range_dft.py), and
  against the float64 DFT within 1e-5; its antenna-mean power is K7's.
- Limits of K7 / K8 (``cube_launch_route``: any antenna count, C <= 256)
  and K10's range tiles (``cfar_tile_plan``: every D <= 256 at S = 400
  fits, a tile too large for a block raises with its reason).

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.ops import power_pallas as jpower
from radar_slam_tpu.ops import rds_pallas as jrds
from radar_slam_tpu.ops import synthpower_pallas as jsp
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.ops import cfar
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops import power, range_dft
from radar_slam_tpu_torch.ops import rds as trds_op
from radar_slam_tpu_torch.ops import synthpower as sp
from radar_slam_tpu_torch.ops.windows import get_window
from radar_slam_tpu_torch.signal.rds import (doppler_columns,
                                             signatures_from_columns)
from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch

F, SC, A, S, K = 2, 16, 4, 128, 12
SEEDS = np.array([11, -4], dtype=np.int32)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def rand_complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _prm(domain):
    return fe.FrontendParams(
        sigma=0.1, noise_taps=((0, 0.5), (1, -0.25), (-1, -0.25)),
        echo_upper=None, dc_removal=True, train=8, guard=2, neighborhood=3,
        offset_db=12.0, threshold_db=-40.0, min_range_bin=1,
        max_range_bin=300, noise_domain=domain, noise_impl="fast",
        cfar_impl="matmul", clutter_offset_db=6.0)


# ---- limits and routes ----------------------------------------------------

@pytest.mark.parametrize("C,route", [(32, "one_block"), (8, "one_block"),
                                     (33, "cluster_rows"),
                                     (64, "cluster_rows"),
                                     (256, "cluster_rows")])
def test_onchip_limits_take_c_up_to_256(C, route):
    """(The one-pass kernels' CFAR holds a [C, S] map and its box sums:
    C <= 72 at S = 400.)"""
    assert fe.cube_onchip_limits(C, 400) == route
    if C <= 64:
        assert fe._check_launch(8, 8, C, 400, _prm("time")) == route
    else:
        with pytest.raises(ValueError, match="the CFAR"):
            fe._check_launch(8, 8, C, 400, _prm("time"))


@pytest.mark.parametrize("C,S", [(257, 400), (0, 400), (32, 600)])
def test_onchip_limits_raise_with_the_reason(C, S):
    with pytest.raises(ValueError, match="on-chip kernel"):
        fe.cube_onchip_limits(C, S)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("A_,C,route,groups", [
    (8, 32, "all_rows", 8), (8, 64, "all_rows", 8),
    (12, 64, "tiled_rows", 8), (16, 64, "tiled_rows", 8),
    (32, 64, "tiled_rows", 8)])
def test_range_freq_rows_tile_over_antenna_groups(split, A_, C, route,
                                                  groups):
    assert fe.z_power_groups(split, A_, C) == groups
    assert fe._check_launch(8, A_, C, 400, _prm("range_freq"),
                            split=split) == route
    if route == "all_rows":
        assert fe._z_power_smem(split, A_, C) <= 232448
    assert fe._z_power_smem(split, A_, C, groups) <= 232448
    assert fe._z_power_smem(split, A_, C, groups + 1) > 232448 or \
        groups == A_


def test_z_power_bytes_match_the_kernel():
    """csrc/frontend.cu:zk_smem_bytes of the split kernel."""
    assert [fe._z_power_smem(True, a, 64) for a in (8, 12, 16)] == [
        223488, 297216, 370944]


def test_routes_are_counted_as_branches():
    prm = _prm("time")
    assert fe._branches(prm, None, 400, "cluster_rows") == (
        "time", "cluster_rows")
    assert fe._branches(_prm("range_freq"), None, 400, "tiled_rows") == (
        "tiled_rows", "wgmma")
    assert fe._branches(prm, None, 400, "one_block") == ("time",)
    for w in (sp.scatterer_power, sp.scatterer_signatures,
              power.rds_power_fused, trds_op.rds_fused):
        assert set(w.branch_launches) == {"dense_range", "cluster_rows"}


@pytest.mark.parametrize("A_,C,route", [(8, 32, "one_block"),
                                        (16, 64, "cluster_rows"),
                                        (32, 64, "cluster_rows"),
                                        (8, 256, "cluster_rows")])
def test_cube_kernels_take_any_antenna_count(A_, C, route):
    """K7 and K8 hold one antenna's rows per block or cluster, so A sets
    only the grid (K8 refused A = 16, C = 64 for its shared memory)."""
    assert power.cube_launch_route(64, A_, C, 400) == route


@pytest.mark.parametrize("F_,A_,C,what", [(64, 16, 257, "on-chip kernel"),
                                          (0, 8, 32, "frames"),
                                          (65536, 8, 32, "frames"),
                                          (64, 0, 32, "antennas")])
def test_cube_kernels_raise_with_the_reason(F_, A_, C, what):
    with pytest.raises(ValueError, match=what):
        power.cube_launch_route(F_, A_, C, 400)


@pytest.mark.parametrize("train,guard,nb", [(8, 2, 3), (0, 0, 3),
                                            (8, 0, 5)])
def test_cfar_tiles_fit_every_doppler_width_to_256(train, guard, nb):
    """K10 refused D > 72 at S = 400 (one block held the frame's map)."""
    halo = max(train + guard if train else 0, nb // 2)
    for D in range(1, 257):
        T, h, smem = cfar.cfar_tile_plan(400, D, train, guard, nb)
        assert h == halo and T % 4 == 0 and 4 <= T <= 32, D
        assert smem <= 232448, D
        if D <= 128:     # two blocks an SM
            assert smem <= 233472 // 2 - 1024, D


def test_cfar_tile_plan_sizes_and_limits():
    # The bench map: 32 rows, a halo of 10, 13 tiles of 400 rows.
    assert cfar.cfar_tile_plan(400, 32, 8, 2, 3)[:2] == (32, 10)
    assert cfar.cfar_tile_plan(400, 256, 8, 2, 3)[0] == 16
    assert cfar.cfar_tile_plan(5, 32, 8, 2, 3)[0] == 8   # R rounded up to 4
    with pytest.raises(ValueError, match="tile of 4 range rows"):
        cfar.cfar_tile_plan(400, 8000, 8, 2, 3)
    with pytest.raises(ValueError, match="halo of 200"):
        cfar.cfar_tile_plan(400, 256, 190, 10, 3)


# ---- K5 in the kernel's order -----------------------------------------------

def _k5_inputs(C, seed):
    rng = np.random.default_rng(seed)
    e_ac = rand_complex(rng, (F, SC, A * C))
    e_fast = rand_complex(rng, (F, SC, S))
    mix = np.hanning(S).astype(np.complex64)
    rb = rng.integers(1, S, (F, K)).astype(np.int32)
    db = rng.integers(0, C, (F, K)).astype(np.int32)
    rb[:, 0] = 0             # the DC bin: zero signatures stay zero
    return e_ac, e_fast, mix, rb, db


@pytest.mark.parametrize("C", [32, 64])
def test_k5_kernel_order_matches_reference_interpret_sigma0(C):
    e_ac, e_fast, mix, rb, db = _k5_inputs(C, C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.scatterer_signatures(
            jnp.asarray(e_ac), jnp.asarray(e_fast), jnp.asarray(SEEDS),
            jnp.asarray(rb), jnp.asarray(db), jnp.asarray(mix), C, 0.0,
            doppler_window="hann", synth_precision="highest",
            sig_precision="highest"))
    t = torch.from_numpy
    got = to_np(sp.scatterer_signatures_factored_reference(
        t(e_ac), t(e_fast), t(SEEDS), t(rb), t(db), t(mix), C, 0.0,
        doppler_window="hann", noise_impl="fast"))
    assert got.shape == want.shape == (F, K, A)
    assert np.abs(got - want).max() < 2e-4
    assert (got[:, 0] == 0).all()
    power_ = np.sum(np.abs(got[:, 1:]) ** 2, axis=-1)
    np.testing.assert_allclose(power_, 1.0, rtol=1e-5)


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_k5_kernel_order_matches_exact_columns(C, sigma):
    """With noise: the gather of the factored FFT's columns equals the
    column products on range_columns_exact (one transform)."""
    e_ac, e_fast, mix, rb, db = (torch.from_numpy(x)
                                 for x in _k5_inputs(C, 100 + C))
    seeds = torch.from_numpy(SEEDS)
    got = sp.scatterer_signatures_factored_reference(
        e_ac, e_fast, seeds, rb, db, mix, C, sigma, doppler_window="hann",
        noise_impl="fast")
    x = sp.synthesize_cube(e_ac, e_fast, seeds, sigma, "fast")
    want = signatures_from_columns(
        x, range_dft.range_columns_exact(S, rb, mix, True),
        doppler_columns(C, db, "hann", "cpu"), A)
    assert float((got - want).abs().max()) < 1e-5
    # The CPU wrapper keeps the reference's columns: within 2e-4.
    ref = sp.scatterer_signatures(e_ac, e_fast, seeds, rb, db, mix, C,
                                  sigma, doppler_window="hann",
                                  noise_impl="fast")
    assert float((got - ref).abs().max()) < 2e-4


# ---- K7 in the kernel's order -----------------------------------------------

@pytest.fixture(scope="module")
def bench_cube():
    """Two noisy bench-scene cubes [2, 8, 32, 400] and the mix."""
    cfg = bench_config()
    _, fields, _ = scene_fields(F)
    sig = synthesize_frames_batch(scatterer_batch_from_numpy(fields, "cpu"),
                                  cfg.radar,
                                  torch.Generator().manual_seed(3))
    mix = get_window("hann", sig.shape[-1], device="cpu").to(
        torch.complex64)
    return to_np(sig), to_np(mix)


@pytest.mark.parametrize("cube", ["bench", "random"])
def test_k7_kernel_order_matches_reference_oracle(bench_cube, cube):
    sig, mix = bench_cube
    if cube == "random":
        sig = rand_complex(np.random.default_rng(5), sig.shape)
    want = np.asarray(jpower.rds_power_reference(
        jnp.asarray(sig), jnp.asarray(mix), True, "hann"))
    got = to_np(power.rds_power_factored_reference(
        torch.from_numpy(sig), torch.from_numpy(mix), True, "hann"))
    assert got.shape == want.shape == (F, 400, 32)
    assert rel(got, want) < 1e-4
    # The float64 DFT of the same function.
    s = np.arange(400)
    w = np.exp(2j * np.pi * np.outer(s, s) / 400) * mix.astype(
        np.complex128)[:, None]
    w[:, 0] = 0
    z = sig.astype(np.complex128) @ w                       # [F, A, C, S]
    wd = to_np(fe.doppler_constant(32, "hann", "cpu")).astype(np.complex128)
    o = wd @ z
    exact = np.mean(np.abs(o) ** 2, axis=1).transpose(0, 2, 1)
    assert rel(got, exact) < 2e-6


def test_cpu_k7_keeps_its_plain_version(bench_cube):
    """rds_power_fused on a CPU tensor runs rds_power_reference (the
    reference's constant) and launches nothing."""
    sig, mix = (torch.from_numpy(x) for x in bench_cube)
    before = power.rds_power_fused.launches
    got = power.rds_power_fused(sig, mix, True, "hann")
    assert power.rds_power_fused.launches == before
    assert torch.equal(got, power.rds_power_reference(sig, mix, True,
                                                      "hann"))


# ---- K8 in the kernel's order -----------------------------------------------

def _exact_rds(sig, mix, C):
    """RDS [..., A, S, C] of cubes [..., A, C, S] in float64 on the exact
    DFT, with K7's Doppler constant."""
    S_ = sig.shape[-1]
    s = np.arange(S_)
    w = np.exp(2j * np.pi * np.outer(s, s) / S_) * mix.astype(
        np.complex128)[:, None]
    w[:, 0] = 0
    wd = to_np(fe.doppler_constant(C, "hann", "cpu")).astype(np.complex128)
    return np.swapaxes(wd @ (sig.astype(np.complex128) @ w), -1, -2)


@pytest.mark.parametrize("C", [32, 64])
def test_k8_kernel_order_matches_reference_interpret(C):
    rng = np.random.default_rng(70 + C)
    sig = rand_complex(rng, (2, 2, C, 128))
    mix = rand_complex(rng, (128,))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrds.rds_fused(jnp.asarray(sig), jnp.asarray(mix),
                                         True, "hann"))
    got = to_np(trds_op.rds_fused_factored_reference(
        torch.from_numpy(sig), torch.from_numpy(mix), True, "hann"))
    assert got.shape == want.shape == (2, 2, 128, C)
    assert got.dtype == np.complex64
    assert rel(got, want) < 2e-4
    assert rel(got, _exact_rds(sig, mix, C)) < 1e-5
    assert (got[..., 0, :] == 0).all()         # the DC range bin


@pytest.mark.parametrize("cube", ["bench", "random"])
def test_k8_kernel_order_matches_exact_dft(bench_cube, cube):
    """The bench cubes [2, 8, 32, 400] (and noise of that shape) against
    the float64 DFT; the CPU wrapper keeps the reference's constant."""
    sig, mix = bench_cube
    if cube == "random":
        sig = rand_complex(np.random.default_rng(6), sig.shape)
    x, m = torch.from_numpy(sig), torch.from_numpy(mix)
    got = to_np(trds_op.rds_fused_factored_reference(x, m, True, "hann"))
    assert rel(got, _exact_rds(sig, mix, 32)) < 1e-5
    assert rel(got, to_np(trds_op.rds_fused(x, m, True, "hann"))) < 2e-4


def test_k8_kernel_order_power_is_k7s(bench_cube):
    sig, mix = (torch.from_numpy(x) for x in bench_cube)
    rds = trds_op.rds_fused_factored_reference(sig, mix, True, "hann")
    p = torch.mean(rds.real * rds.real + rds.imag * rds.imag, dim=-3)
    want = power.rds_power_factored_reference(sig, mix, True, "hann")
    assert rel(to_np(p), to_np(want)) < 1e-6
