"""PyTorch port vs JAX reference: frame-independent constants, synthesis
factors and the scene generator.

Tolerances: the constants are float32 values of magnitude <= 1 built with
the same float32 operation order in both packages, so they agree to a few
ulps of 1 (1e-6 absolute); only the transcendental implementations differ.
The scene generator shares its numpy core, so its columns are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np

from radar_slam_tpu.aoa import estimators as jest
from radar_slam_tpu.ops import windows as jwin
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu.signal import rds as jrds
from radar_slam_tpu.signal import synth as jsynth
from radar_slam_tpu_torch.aoa import estimators as t_est
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.io import synthetic as tsyn
from radar_slam_tpu_torch.ops import windows as twin
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal import rds as trds
from radar_slam_tpu_torch.signal import synth as tsynth

ATOL = 1e-6


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "rect"])
@pytest.mark.parametrize("n,periodic", [(400, False), (400, True),
                                        (32, False), (32, True)])
def test_windows_and_taps_match(name, n, periodic):
    np.testing.assert_allclose(
        to_np(twin.get_window(name, n, periodic)),
        to_np(jwin.get_window(name, n, periodic)), rtol=0, atol=ATOL)
    assert twin.window_freq_taps(name) == jwin.window_freq_taps(name)


def test_dft_constants_mix_gate_and_grid_match():
    cfg = bench_config()
    S, C = cfg.radar.samples_per_chirp, cfg.radar.num_chirps
    mix_t = trds._mix_vector(cfg.radar, cfg.window, "baseband", S)
    mix_j = jrds._mix_vector(cfg.radar, cfg.window, "baseband", S)
    np.testing.assert_allclose(to_np(mix_t), to_np(mix_j), rtol=0,
                               atol=ATOL)
    for dc in (True, False):
        np.testing.assert_allclose(
            to_np(trds.range_dft_matrix(S, mix_t, dc)),
            to_np(jrds.range_dft_matrix(S, mix_j, dc)), rtol=0, atol=ATOL)
    for win in ("hann", None):
        np.testing.assert_allclose(
            to_np(trds.doppler_dft_matrix(C, win)),
            to_np(jrds.doppler_dft_matrix(C, win)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_np(trds.range_axis_m(cfg.radar)),
                               to_np(jrds.range_axis_m(cfg.radar)),
                               rtol=1e-7)
    np.testing.assert_allclose(to_np(trds.doppler_axis_hz(cfg.radar)),
                               to_np(jrds.doppler_axis_hz(cfg.radar)),
                               rtol=1e-7)
    assert (tdet.range_gate_bin_interval(cfg.radar, S, cfg.detection)
            == jdet.range_gate_bin_interval(cfg.radar, S, cfg.detection))
    # The reference's float32 linspace misses some integer grid points by
    # an ulp (XLA's own rounding); the port rounds exact values once.
    np.testing.assert_allclose(to_np(t_est.azimuth_grid_deg(cfg.aoa)),
                               to_np(jest.azimuth_grid_deg(cfg.aoa)),
                               rtol=0, atol=2 * np.spacing(np.float32(90)))
    # The steering phase (2 pi / lambda) sin(az) n d reaches 7 pi sin(az):
    # one float32 ulp of sin(az) between the two libms is ~1.3e-6 rad.
    np.testing.assert_allclose(
        to_np(t_est.grid_steering_matrix(cfg.radar, cfg.aoa)),
        to_np(jest.grid_steering_matrix(cfg.radar, cfg.aoa)), rtol=0,
        atol=4 * ATOL)


def test_geometry_matches():
    """Steering vectors, line-of-sight directions, polar -> cartesian and
    angle wrapping on the same float32 angles."""
    from radar_slam_tpu.core import geometry as jgeo
    from radar_slam_tpu_torch.core import geometry as tgeo
    cfg = bench_config().radar
    rng = np.random.default_rng(2)
    az = rng.uniform(-1.5, 1.5, (4, 16)).astype(np.float32)
    el = rng.uniform(-0.3, 0.3, (4, 16)).astype(np.float32)
    r = rng.uniform(1.0, 60.0, (4, 16)).astype(np.float32)
    th = rng.uniform(-30.0, 30.0, (4, 16)).astype(np.float32)
    t = torch.tensor
    np.testing.assert_allclose(
        to_np(tgeo.steering_vector(t(az), 8, cfg.spacing, cfg.lambda_c)),
        to_np(jgeo.steering_vector(jnp.asarray(az), 8, cfg.spacing,
                                   cfg.lambda_c)), rtol=0, atol=4 * ATOL)
    np.testing.assert_allclose(
        to_np(tgeo.direction_vector(t(az), t(el))),
        to_np(jgeo.direction_vector(jnp.asarray(az), jnp.asarray(el))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        to_np(tgeo.polar_to_cartesian(t(r), t(az), t(el))),
        to_np(jgeo.polar_to_cartesian(jnp.asarray(r), jnp.asarray(az),
                                      jnp.asarray(el))), rtol=1e-6,
        atol=ATOL)
    np.testing.assert_allclose(to_np(tgeo.wrap_angle(t(th))),
                               to_np(jgeo.wrap_angle(jnp.asarray(th))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fid", ["tpu", "reference"])
def test_synthesis_factors_split_match(fid):
    """Per-axis phase tables for every frame: identical float32 cycle
    arithmetic, reduced mod 1 before the transcendental, so the factors
    agree to float32 rounding of the trig (the amplitude scales ant)."""
    cfg = bench_config()
    jbatch, fields, _ = scene_fields(3)
    ref = jax.vmap(lambda s: jsynth.synthesis_factors_split(
        s, cfg.radar, fid))(jbatch)
    got = tsynth.synthesis_factors_split(
        scatterer_batch_from_numpy(fields, "cpu"), cfg.radar, fid)
    for name in ("dopp", "coarse", "fine"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   to_np(getattr(ref, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    amp = np.abs(to_np(ref.ant)).max()
    np.testing.assert_allclose(to_np(got.ant), to_np(ref.ant), rtol=0,
                               atol=ATOL * amp)
    np.testing.assert_array_equal(to_np(got.tau), to_np(ref.tau))
    np.testing.assert_allclose(
        to_np(tsynth.fast_time_base(cfg.radar, fid)),
        to_np(jsynth.fast_time_base(cfg.radar, fid)), rtol=0, atol=0)


def test_expj_cycles_reduces_large_phases():
    x = np.random.default_rng(0).uniform(-3e4, 3e4, 4096).astype(np.float32)
    got = to_np(tsynth.expj_cycles(torch.tensor(x)))
    ref = to_np(jsynth.expj_cycles(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.abs(got), 1.0, atol=1e-6)


def test_constant_motion_scene_bit_equal():
    """Same numpy core, same seed -> bit-identical scatterer columns and
    ground truth."""
    cfg = bench_config()
    _, fields, gt = scene_fields(16)
    batch, gt_t = tsyn.constant_motion_scene(
        7, num_frames=16, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=tsyn.SceneConfig(num_points=96, max_scatterers=128))
    for name, ref in fields.items():
        got = to_np(getattr(batch, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert batch.elevation_rad is None
    for key in ("poses", "velocity_body", "timestamps"):
        np.testing.assert_array_equal(gt_t[key], gt[key])
    assert gt_t["yaw_rate"] == gt["yaw_rate"]
    for seed in (0, 3):
        for a, b in zip(tsyn.make_world_points(seed, tsyn.SceneConfig()),
                        _jax_world_points(seed)):
            np.testing.assert_array_equal(a, b)


def _jax_world_points(seed):
    from radar_slam_tpu.io.synthetic import SceneConfig, make_world_points
    return make_world_points(seed, SceneConfig())
