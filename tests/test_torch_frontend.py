"""The port's one-pass front end (radar_slam_tpu_torch/ops/frontend.py) vs
the reference Pallas kernel (ops/frontend_pallas.py:scatterer_frontend_split)
run in interpret mode, at the production knobs (split factors,
range-frequency noise, "fast" Gaussians, box-sum CA-CFAR, two-stage top-K)
and sigma = 0: interpret mode's PRNG is degenerate, and the port's noise is
checked distributionally in test_torch_noise.py.

Tolerances follow tests/test_frontend.py:90-122 and :391-408: the power map
to 1e-5 of its maximum (float32 matmuls against the reference's bf16x3),
detection sets equal up to one borderline CFAR flip (box sums summed in
another order), signatures of matched valid slots within 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.ops.windows import window_freq_taps as jtaps
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu.signal.rds import _mix_vector as jmix
from radar_slam_tpu.signal.synth import fast_time_base as jtime
from radar_slam_tpu.signal.synth import synthesis_factors_split as jsplit
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.windows import window_freq_taps
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal.rds import _mix_vector
from radar_slam_tpu_torch.signal.synth import (fast_time_base,
                                               synthesis_factors_split)

F = 3


def _port_frontend(cfg, fields, seeds, **over):
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    d = cfg.detection
    lo, hi = tdet.range_gate_bin_interval(cfg.radar, S, d)
    split = synthesis_factors_split(scatterer_batch_from_numpy(fields, "cpu"),
                                    cfg.radar)
    kw = dict(train=d.cfar_train_cells, guard=d.guard_cells,
              neighborhood=d.neighborhood, offset_db=d.cfar_offset_db,
              threshold_db=d.threshold_db, min_range_bin=lo,
              max_range_bin=hi, doppler_window=cfg.doppler_window,
              noise_impl=cfg.noise_impl, noise_domain=cfg.noise_domain,
              noise_taps=window_freq_taps(cfg.window),
              topk_mode=cfg.frontend_topk)
    kw.update(over)
    return fe.scatterer_frontend_split(
        split.ant, split.dopp, split.coarse, split.fine, split.tau,
        fast_time_base(cfg.radar), seeds,
        _mix_vector(cfg.radar, cfg.window, "baseband", S), C,
        float(cfg.radar.noise_power) ** 0.5, d.max_detections, **kw)


@pytest.fixture(scope="module")
def outputs():
    cfg = bench_config(noise_power=0.0)
    jbatch, fields, _ = scene_fields(F)
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    d = cfg.detection
    lo, hi = jdet.range_gate_bin_interval(cfg.radar, S, d)
    split = jax.vmap(lambda s: jsplit(s, cfg.radar))(jbatch)
    seeds = np.arange(F, dtype=np.int32) + 29
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.scatterer_frontend_split(
            split.ant, split.dopp, split.coarse, split.fine, split.tau,
            jtime(cfg.radar), jnp.asarray(seeds),
            jmix(cfg.radar, cfg.window, "baseband", S), C, 0.0,
            d.max_detections, train=d.cfar_train_cells, guard=d.guard_cells,
            neighborhood=d.neighborhood, offset_db=d.cfar_offset_db,
            threshold_db=d.threshold_db, min_range_bin=lo, max_range_bin=hi,
            doppler_window=cfg.doppler_window,
            doppler_precision=cfg.synth_doppler_precision,
            doppler_layout=cfg.synth_doppler_layout,
            noise_impl=cfg.noise_impl, noise_domain=cfg.noise_domain,
            noise_taps=jtaps(cfg.window), topk_mode=cfg.frontend_topk)
        ref = tuple(map(np.asarray, ref))
    got = tuple(map(to_np, _port_frontend(cfg, fields,
                                          torch.tensor(seeds))))
    return cfg, ref, got


def test_frontend_power_map_matches(outputs):
    _, (p_ref, *_), (p, *_) = outputs
    assert p.shape == p_ref.shape == (F, 400, 32)
    assert np.abs(p - p_ref).max() / p_ref.max() < 1e-5


def test_frontend_detections_and_signatures_match(outputs):
    _, (_, rb1, db1, v1, s1), (_, rb2, db2, v2, s2) = outputs
    assert rb2.dtype == db2.dtype == np.int32
    assert s2.dtype == np.complex64 and s2.shape == (F, 64, 8)
    val1, val2 = v1 > -np.inf, v2 > -np.inf
    set1 = {(f, int(r), int(d)) for f in range(F)
            for r, d, ok in zip(rb1[f], db1[f], val1[f]) if ok}
    set2 = {(f, int(r), int(d)) for f in range(F)
            for r, d, ok in zip(rb2[f], db2[f], val2[f]) if ok}
    assert set1, "no detections"
    assert len(set1 ^ set2) <= 1, (len(set1 ^ set2), len(set1))
    both = val1 & val2 & (rb1 == rb2) & (db1 == db2)
    assert both.sum() >= 0.95 * val1.sum()
    assert np.abs(s1[both] - s2[both]).max() < 2e-4
    # Slot values are dB of the power map: hold them in the linear domain
    # to the power map's own tolerance (weak cells carry more relative
    # error in dB).
    p_max = outputs[1][0].max()
    lin = lambda v: 10.0 ** (v.astype(np.float64) / 10.0)
    assert np.abs(lin(v2[both]) - lin(v1[both])).max() / p_max < 1e-5
    # Exhausted slots carry -inf, as in the reference.
    assert np.array_equal(np.isneginf(v1), np.isneginf(v2))


def test_topk_exact_matches_lax_top_k_with_ties():
    """Stable descending sort == lax.top_k, including its smaller-index
    tie order (NMS downstream suppresses by slot order) and the sentinel
    / -inf fills."""
    rng = np.random.default_rng(0)
    for _ in range(12):
        N = int(rng.choice([12800, 777, 130, 64]))
        x = rng.choice([-np.inf, -1e30, 0.5, 1.0, 3.25, 7.0], size=(3, N),
                       p=[.3, .3, .1, .1, .1, .1]).astype(np.float32)
        # Planted ties: only half the finite cells get jitter.
        jitter = rng.standard_normal((3, N)).astype(np.float32)
        x += jitter * (x > -1e29) * (rng.random((3, N)) < 0.5)
        K = int(rng.choice([5, 50, 64]))
        v1, i1 = jax.lax.top_k(jnp.asarray(x), K)
        v2, i2 = fe.topk_exact(torch.tensor(x), K)
        np.testing.assert_array_equal(to_np(v2), np.asarray(v1))
        np.testing.assert_array_equal(to_np(i2), np.asarray(i1))


def test_cpu_tensors_run_the_plain_version(outputs):
    """On the CPU the kernel wrapper runs the plain version and launches
    nothing: the launch count only moves on the card."""
    cfg, _, (p, *_) = outputs
    _, fields, _ = scene_fields(F)
    before = fe.frontend_kernel_split.launches
    again = _port_frontend(cfg, fields,
                           torch.arange(F, dtype=torch.int32) + 29)
    assert fe.frontend_kernel_split.launches == before
    np.testing.assert_array_equal(to_np(again[0]), p)


@pytest.mark.parametrize("knob,value,exc", [
    ("noise_domain", "freq", ValueError),
    ("noise_impl", "ziggurat", ValueError),
    ("cfar_impl", "fft", ValueError),
    ("clutter", torch.zeros(F, 32, 400), ValueError),
    ("noise_taps", (), ValueError),
    ("topk_mode", "heap", ValueError),
])
def test_unported_knobs_raise(knob, value, exc):
    """Every knob value of the reference's wrapper is ported (K1'); an
    unknown name, a clutter map in the wrong layout and range-frequency
    noise without the window's taps raise."""
    cfg = bench_config(noise_power=0.0)
    _, fields, _ = scene_fields(F)
    with pytest.raises(exc):
        _port_frontend(cfg, fields, torch.zeros(F, dtype=torch.int32),
                       **{knob: value})


def test_wrapper_checks_its_inputs():
    cfg = bench_config(noise_power=0.0)
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    _, fields, _ = scene_fields(F)
    split = synthesis_factors_split(scatterer_batch_from_numpy(fields, "cpu"),
                                    cfg.radar)
    w_rng, w_dop_t = fe.frontend_constants(
        C, S, _mix_vector(cfg.radar, cfg.window, "baseband", S), True,
        cfg.doppler_window)
    prm = fe.FrontendParams(
        sigma=0.0, noise_taps=window_freq_taps(cfg.window), echo_upper=None,
        dc_removal=True, train=8, guard=2, neighborhood=3, offset_db=12.0,
        threshold_db=-25.0, min_range_bin=1, max_range_bin=S - 1,
        noise_domain="range_freq", noise_impl="fast", cfar_impl="matmul",
        clutter_offset_db=6.0)
    args = [split.ant, split.dopp, split.coarse, split.fine, split.tau,
            fast_time_base(cfg.radar), torch.zeros(F, dtype=torch.int32),
            w_rng, w_dop_t]
    fe.frontend_kernel_split(*args, prm)
    bad_dtype = list(args)
    bad_dtype[6] = torch.zeros(F, dtype=torch.float32)
    with pytest.raises(TypeError):
        fe.frontend_kernel_split(*bad_dtype, prm)
    bad_shape = list(args)
    bad_shape[7] = w_rng[:, :-1]
    with pytest.raises(ValueError):
        fe.frontend_kernel_split(*bad_shape, prm)
    with pytest.raises(ValueError):
        fe.frontend_kernel_split(*args, fe.FrontendParams(
            **{**prm.__dict__, "neighborhood": 4}))
