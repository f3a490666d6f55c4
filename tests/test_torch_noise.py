"""The port's counter-based Gaussian generator (ops/noise.py) and the
front end's spectral noise construction.

The reference draws its front-end noise from the TPU's in-kernel PRNG,
whose bits exist nowhere else (and are degenerate in interpret mode), so
parity here is distributional: the same "fast" transform (exact Rayleigh
radius, 45-degree-staggered Irwin-Hall direction) must produce standard
normals, and the plain front end must apply exactly
sqrt(S) * (g (*) taps) with the DC column zeroed, as
tests/test_frontend.py:test_spectral_noise_exact_construction checks for
the TPU kernel.  The CUDA kernel draws the same Philox words for the same
(seed, index); chip_smoke.py holds it to this plain version on the card.
"""

import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from scipy import stats

from radar_slam_tpu.ops.windows import get_window as jax_get_window
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.noise import philox4x32, standard_normals
from radar_slam_tpu_torch.ops.windows import window_freq_taps
from radar_slam_tpu_torch.signal.rds import range_dft_matrix
from radar_slam_tpu_torch.signal.synth import (fast_time_base,
                                               synthesis_factors_split)

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox-4x32-10 known-answer vectors, evaluated on int64
    tensors (the 32x32-bit products split into 16-bit halves)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    got = philox4x32(tuple(t(c) for c in ctr), tuple(t(k) for k in key))
    assert tuple(int(w) for w in got) == want


@pytest.fixture(scope="module")
def normals():
    seeds = torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, 7, 99],
                         dtype=torch.int32)
    gr, gi = standard_normals(seeds, 256, 400)
    return to_np(gr).astype(np.float64), to_np(gi).astype(np.float64)


def test_normals_moments_ks_and_isotropy(normals):
    gr, gi = normals
    x = np.concatenate([gr.ravel(), gi.ravel()])           # 1.6M samples
    assert np.isfinite(x).all()
    assert abs(x.mean()) < 5e-3
    assert abs(x.var() - 1.0) < 5e-3
    assert abs(stats.kurtosis(x)) < 0.02
    assert stats.kstest(gr.ravel(), "norm").pvalue > 1e-3
    assert stats.kstest(gi.ravel(), "norm").pvalue > 1e-3
    # Isotropy: E[x^2 y^2] = 1 for independent normal planes, and the
    # direction is uniform (64-bin chi-square).
    assert abs(np.mean(gr.ravel() ** 2 * gi.ravel() ** 2) - 1.0) < 0.02
    ang = np.arctan2(gi.ravel(), gr.ravel())
    hist, _ = np.histogram(ang, bins=64, range=(-np.pi, np.pi))
    chi2 = np.sum((hist - hist.mean()) ** 2 / hist.mean())
    assert chi2 / 63 < 1.6
    # The exact Rayleigh radius keeps the tails: P(|x| > 4) = 6.3e-5.
    n4 = int(np.sum(np.abs(x) > 4.0))
    expect = 2 * stats.norm.sf(4.0) * x.size
    assert 0.5 * expect < n4 < 1.6 * expect
    assert np.abs(x).max() > 4.5


def test_normals_streams_by_seed_and_index(normals):
    gr, _ = normals
    # Distinct seeds give uncorrelated planes; the same seed repeats.
    c = np.corrcoef(gr[0].ravel(), gr[1].ravel())[0, 1]
    assert abs(c) < 0.01
    again = to_np(standard_normals(torch.tensor([0], dtype=torch.int32),
                                   256, 400)[0])
    np.testing.assert_array_equal(again[0], gr[0].astype(np.float32))
    # Element (i, j) depends only on (seed, i * cols + j): a narrower plane
    # is the same stream re-shaped.
    flat = to_np(standard_normals(torch.tensor([0], dtype=torch.int32),
                                  1, 256 * 400)[0])
    np.testing.assert_array_equal(flat.reshape(256, 400),
                                  gr[0].astype(np.float32))


def test_spectral_noise_exact_construction():
    """Signal = 0, sigma = 1: the plain front end's Z and power map equal
    the numpy construction from the SAME g planes: Z_n = sqrt(S) (g (*)
    taps) with column 0 zeroed, p = mean_a |sum_c w_dop Z|^2."""
    cfg = bench_config()
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    A = cfg.radar.num_antennas
    _, fields, _ = scene_fields(2)
    split = synthesis_factors_split(scatterer_batch_from_numpy(fields, "cpu"),
                                    cfg.radar)
    seeds = torch.tensor([29, -5], dtype=torch.int32)
    mix = torch.tensor(np.asarray(
        jax_get_window(cfg.window, S))).to(torch.complex64)
    w_rng = range_dft_matrix(S, mix, True)
    w_dop_t = fe.doppler_constant(C, cfg.doppler_window, "cpu")
    taps = window_freq_taps(cfg.window)
    prm = fe.FrontendParams(
        sigma=1.0, noise_taps=taps, echo_upper=None, dc_removal=True,
        train=8, guard=2, neighborhood=3, offset_db=12.0, threshold_db=-25.0,
        min_range_bin=1, max_range_bin=S - 1, noise_domain="range_freq",
        noise_impl="fast", cfar_impl="matmul", clutter_offset_db=6.0)
    zr, zi, p, _ = fe.scatterer_frontend_split_reference(
        torch.zeros_like(split.ant), split.dopp, split.coarse, split.fine,
        split.tau, fast_time_base(cfg.radar, device="cpu"), seeds, w_rng,
        w_dop_t, prm)

    gr, gi = (to_np(x).astype(np.float64)
              for x in standard_normals(seeds, A * C, S))
    g = gr + 1j * gi
    zn = np.zeros_like(g)
    for off, ccf in taps:
        zn += ccf * np.roll(g, off, axis=-1)
    zn *= np.sqrt(S)
    zn[..., 0] = 0.0
    np.testing.assert_allclose(to_np(zr), zn.real.transpose(0, 2, 1),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(zi), zn.imag.transpose(0, 2, 1),
                               rtol=0, atol=1e-4)
    c_idx = np.arange(C, dtype=np.float64)
    k_shifted = np.roll(np.arange(C, dtype=np.float64), C // 2)
    wd = np.exp(-1j * (2.0 * np.pi / C) * np.outer(c_idx, k_shifted))
    wd = np.asarray(jax_get_window(cfg.doppler_window, C))[:, None] * wd
    rds = np.einsum("facs,cd->fads", zn.reshape(-1, A, C, S), wd)
    p_ref = np.mean(np.abs(rds) ** 2, axis=1)                   # [F, D, S]
    assert np.abs(to_np(p) - p_ref).max() / p_ref.max() < 1e-5
