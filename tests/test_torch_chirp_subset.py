"""Chirp subsets (``PipelineConfig.chirp_subset``) in the port against the
JAX reference on the CPU.

- The cube kernels' routes at a subset (K7 ``rds_power(mode="pallas")``,
  K8 ``fft_mode="pallas"``, K9 ``fft_mode="fft", use_pallas=True``) on a
  [2, 8, 32, 400] cube at subsets (0, 16) and (3, 28) of its 32 chirps
  (C = 25 takes the explicit fftshift branch), against the reference's
  kernels in interpret mode (K7's products at "highest", float32 as the
  port computes): 1e-5 of the maximum, the tolerance
  ``tests/test_torch_cube.py`` holds the same formulations to.
- The drivers at a subset on a narrow radar (32 chirps, 128 samples, 3
  frames) at sigma = 0 against the reference's (``DRIVER_CASES``): the
  batched cube driver on its fused route at both subsets and on K8's
  route, the sequential cube driver, ``process_sequence_batched``,
  ``process_sequence``, ``process_sequence_chunked`` and the rig (the
  scatterer drivers' synthesis evaluated eagerly in the reference,
  ``_torch_parity.patch_eager_synthesis``); and the port's remaining
  routes (the cube driver's "fft" and "matmul" RDS, the scatterer
  drivers at the other subset) held to those at both subsets.  Counts
  and solve outcomes exact, velocities to 1e-3 m/s and poses to 1e-4 m:
  ``tests/test_torch_sequential.py``'s tolerances for its materialized
  drivers at sigma = 0.
- The smoothing keys range_bin * D + doppler_bin take D from the subset
  in the batched and the chunked drivers, as the reference's do.
- ``pipeline_scatterer_pad`` pads and cuts as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, patch_eager_synthesis, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.core import config as jcfg
from radar_slam_tpu.io import synthetic as jsyn
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.pipeline import rig as jrig
from radar_slam_tpu.signal import rds as jrds
from radar_slam_tpu_torch.aoa import smoothing as tsmoothing
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import (scatterer_batch_from_numpy,
                                             signals_from_numpy)
from radar_slam_tpu_torch.io.synthetic import pipeline_scatterer_pad
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.pipeline import rig as trig
from radar_slam_tpu_torch.signal import rds as trds
from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch

SUBSETS = [(0, 16), (3, 28)]
FRAMES = 3
RIG2 = ((1.8, 0.9, 0.4), (1.8, -0.9, -0.4))


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def cube():
    rng = np.random.default_rng(11)
    shape = (2, 8, 32, 400)
    sig = (rng.standard_normal(shape)
           + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return bench_config(), sig


@pytest.mark.parametrize("subset", SUBSETS)
@pytest.mark.parametrize("route", ["rds_pallas", "fft_use_pallas",
                                   "power_pallas"])
def test_cube_kernel_routes_take_a_chirp_subset(cube, route, subset):
    """The subset is a strided view of the chirp axis; the kernels'
    wrappers need a contiguous cube, so the subset is copied where it is
    taken (``signal/rds.py:_subset``)."""
    cfg, sig = cube
    kw = dict(window=cfg.window, chirp_subset=subset,
              doppler_window=cfg.doppler_window)
    x = signals_from_numpy(sig, "cpu")
    with pltpu.force_tpu_interpret_mode():
        if route == "power_pallas":
            want = np.asarray(jrds.rds_power(
                jnp.asarray(sig), cfg.radar, mode="pallas", **kw,
                dft_precision="highest", doppler_precision="highest"))
        else:
            fft_mode = "pallas" if route == "rds_pallas" else "fft"
            want = np.asarray(jrds.range_doppler_spectrum(
                jnp.asarray(sig), cfg.radar, fft_mode=fft_mode,
                use_pallas=True, **kw))
    if route == "power_pallas":
        got = to_np(trds.rds_power(x, cfg.radar, mode="pallas", **kw))
    else:
        got = to_np(trds.range_doppler_spectrum(
            x, cfg.radar, fft_mode="pallas" if route == "rds_pallas"
            else "fft", use_pallas=True, **kw))
    D = subset[1] - subset[0]
    assert got.shape == want.shape and got.shape[-1] == D
    assert rel(got, want) < 1e-5


# ---- the drivers -------------------------------------------------------------

def _narrow(subset, **over):
    """A narrow radar at 32 chirps (250 MHz over 12.8 us, 128 samples:
    0.6 m bins out to 76.8 m), sigma = 0, the fused power map, and the
    port's copy of it."""
    ref = jcfg.PipelineConfig(
        radar=jcfg.RadarConfig(noise_power=0.0, num_chirps=32,
                               bandwidth=250e6, chirp_duration=12.8e-6),
        detection=jcfg.DetectionConfig(cfar_train_cells=4, guard_cells=1,
                                       cfar_offset_db=12.0,
                                       max_detections=32),
        aoa=jcfg.AoAConfig(search_resolution_deg=2.0,
                           confidence_threshold=0.5, max_targets=32),
        max_scatterers=64, chirp_subset=subset,
        **{"fft_mode": "fused", **over})
    return ref, config_from_dict(dataclasses.asdict(ref))


def _scene(n_frames, rig=None):
    scene = jsyn.SceneConfig(num_points=48, max_scatterers=64)
    if rig is None:
        jbatch, _ = jsyn.constant_motion_scene(
            5, num_frames=n_frames, dt=0.1, v_body=(6.0, -0.5),
            yaw_rate=0.08, scene=scene)
    else:
        jbatch, _ = jsyn.constant_motion_scene_rig(
            11, num_frames=n_frames, dt=0.1, v_body=(6.0, -0.5),
            yaw_rate=0.08, rig=rig, scene=scene)
    fields = {k: np.asarray(v) for k, v in jbatch._asdict().items()
              if v is not None}
    return jbatch, scatterer_batch_from_numpy(fields, "cpu")


def _assert_outputs(got, ref):
    for name in ("num_detections", "num_reliable", "num_associations"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    assert to_np(got.num_detections).min() > 0
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  np.asarray(ref.motion.success))
    np.testing.assert_allclose(to_np(got.motion.velocity),
                               np.asarray(ref.motion.velocity), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(to_np(got.pose), np.asarray(ref.pose),
                               rtol=0, atol=1e-4)


# The drivers held to the reference's, one case per driver and subset (a
# reference driver's compile costs ~4 s here).  Every driver at a subset
# sees the same noiseless cubes: the cube drivers take the synthesis of
# the scene's scatterers, which the scatterer drivers (on the materialized
# route a subset takes) synthesize in both packages.
DRIVER_CASES = [
    ("cube_batched_fused", (3, 28)), ("cube_batched_pallas", (0, 16)),
    ("cube_sequential", (0, 16)), ("rig_batched", (0, 16)),
    ("cube_batched_fused", (0, 16)), ("scatterer_batched", (0, 16)),
    ("scatterer_sequential", (3, 28)), ("scatterer_chunked", (3, 28))]
CUBE_DRIVERS = {
    "cube_batched_fused": ("process_signal_sequence_batched",
                           dict(fft_mode="fused", use_pallas=False)),
    "cube_batched_pallas": ("process_signal_sequence_batched",
                            dict(fft_mode="pallas", use_pallas=True)),
    "cube_sequential": ("process_signal_sequence", {})}
SCATTERER_DRIVERS = {
    "scatterer_batched": ("process_sequence_batched", {}),
    "scatterer_sequential": ("process_sequence", {}),
    "scatterer_chunked": ("process_sequence_chunked",
                          dict(window=2, prior="exact"))}


@pytest.fixture(scope="module")
def narrow_scene():
    """The scene (both packages' batches) and its noiseless cubes."""
    jbatch, batch = _scene(FRAMES)
    sig = synthesize_frames_batch(batch, _narrow(None)[1].radar,
                                  torch.Generator(), add_noise=False)
    return jbatch, batch, to_np(sig)


@pytest.fixture(scope="module")
def reference(narrow_scene):
    """The reference's output of (driver, subset), each driver run and
    compiled once in this module; its scatterer drivers' synthesis
    evaluated eagerly (``_torch_parity.patch_eager_synthesis``)."""
    mp = pytest.MonkeyPatch()
    patch_eager_synthesis(mp, jframe, jrig)
    jbatch, _, sig = narrow_scene
    outputs = {}

    def run(driver, subset):
        ref_cfg = _narrow(subset)[0]
        if driver == "rig_batched":
            return jrig.process_sequence_rig_batched(
                _scene(FRAMES, RIG2)[0], jax.random.key(0), ref_cfg, RIG2)
        if driver in SCATTERER_DRIVERS:
            fn, kw = SCATTERER_DRIVERS[driver]
            return getattr(jframe, fn)(jbatch, jax.random.key(0), ref_cfg,
                                       **kw)
        fn, knobs = CUBE_DRIVERS[driver]
        with pltpu.force_tpu_interpret_mode():
            return jax.block_until_ready(getattr(jframe, fn)(
                jnp.asarray(sig), _narrow(subset, **knobs)[0]))

    def get(driver, subset):
        if (driver, subset) not in outputs:
            outputs[driver, subset] = run(driver, subset)
        return outputs[driver, subset]

    yield get
    mp.undo()


@pytest.mark.parametrize("driver,subset", DRIVER_CASES)
def test_drivers_at_a_chirp_subset_match_reference(driver, subset,
                                                   narrow_scene, reference):
    _, batch, sig = narrow_scene
    if driver == "rig_batched":
        got = trig.process_sequence_rig_batched(
            _scene(FRAMES, RIG2)[1], torch.Generator(), _narrow(subset)[1],
            RIG2)
    elif driver in SCATTERER_DRIVERS:
        fn, kw = SCATTERER_DRIVERS[driver]
        got = getattr(tframe, fn)(batch, torch.Generator(),
                                  _narrow(subset)[1], **kw)
    else:
        fn, knobs = CUBE_DRIVERS[driver]
        got = getattr(tframe, fn)(signals_from_numpy(sig, "cpu"),
                                  _narrow(subset, **knobs)[1])
    _assert_outputs(got, reference(driver, subset))


@pytest.mark.parametrize("subset", SUBSETS)
def test_other_drivers_agree_at_a_chirp_subset(subset, narrow_scene,
                                               reference):
    """At each subset the port's routes that DRIVER_CASES does not take
    there are held to the reference's driver of the same semantics on the
    same cubes (its outputs shared with the test above): the cube driver's
    "fft" and "matmul" RDS routes and ``process_sequence_batched`` to the
    reference's fused batched cube driver; ``process_signal_sequence``,
    ``process_sequence`` and ``process_sequence_chunked`` (exact prior) to
    the reference's sequential driver, at the test's tolerances.  The
    chunked driver is also held to the port's sequential one to 1e-5 m,
    as tests/test_torch_sequential.py holds them."""
    _, cfg = _narrow(subset)
    assert tframe._phase_a_route(
        dataclasses.replace(cfg, synth_in_kernel=True)) == "materialized"
    _, batch, sig = narrow_scene
    x = signals_from_numpy(sig, "cpu")
    batched = reference("cube_batched_fused", subset)
    assert np.asarray(batched.motion.success)[1:].all()
    for mode in ("fft", "matmul"):
        _assert_outputs(tframe.process_signal_sequence_batched(
            x, dataclasses.replace(cfg, fft_mode=mode)), batched)
    _assert_outputs(tframe.process_sequence_batched(batch, torch.Generator(),
                                                    cfg), batched)
    sequential = reference(next(
        d for d in ("cube_sequential", "scatterer_sequential")
        if (d, subset) in DRIVER_CASES), subset)
    _assert_outputs(tframe.process_signal_sequence(x, cfg), sequential)
    seq = tframe.process_sequence(batch, torch.Generator(), cfg)
    _assert_outputs(seq, sequential)
    chunked = tframe.process_sequence_chunked(batch, torch.Generator(), cfg,
                                              window=2, prior="exact")
    _assert_outputs(chunked, sequential)
    np.testing.assert_allclose(to_np(chunked.pose), to_np(seq.pose), rtol=0,
                               atol=1e-5)


def test_smoothing_keys_take_d_from_the_subset(monkeypatch):
    """The keys the batched and the chunked drivers hand
    ``smooth_windowed`` are range_bin * D + doppler_bin with D = 16, the
    subset's length, as the reference's (its frame.py:858-859, :366-367)."""
    seen = []
    inner = tsmoothing.smooth_windowed

    def wrapped(keys, *args, **kwargs):
        seen.append(to_np(keys).copy())
        return inner(keys, *args, **kwargs)

    monkeypatch.setattr(tsmoothing, "smooth_windowed", wrapped)
    _, cfg = _narrow((0, 16))
    _, batch = _scene(FRAMES)
    sig = synthesize_frames_batch(batch, cfg.radar, torch.Generator(),
                                  add_noise=False)
    det = tframe.frame_features(sig, cfg)[0]
    tframe.process_sequence_batched(batch, torch.Generator(), cfg)
    tframe.process_sequence_chunked(batch, torch.Generator(), cfg,
                                    window=FRAMES)
    batched, chunked = seen
    db = to_np(det.doppler_bin)
    np.testing.assert_array_equal(batched,
                                  to_np(det.range_bin) * 16 + db)
    assert db.max() < 16 and batched.max() > 32
    kept = chunked[-FRAMES:] >= 0
    np.testing.assert_array_equal(chunked[-FRAMES:][kept], batched[kept])


def test_pipeline_scatterer_pad_matches_reference():
    """Padding (zeros, ``valid`` False) and cutting to max_scatterers, the
    elevation column included, bit for bit."""
    jbatch, _ = jsyn.constant_motion_scene_3d(
        3, num_frames=2, dt=0.1, v_body=(5.0, 0.0, 0.5), yaw_rate=0.0,
        scene=jsyn.SceneConfig(num_points=20, max_scatterers=40))
    fields = {k: np.asarray(v) for k, v in jbatch._asdict().items()}
    batch = scatterer_batch_from_numpy(fields, "cpu")
    for size in (64, 40, 12):
        ref_cfg, cfg = _narrow(None)
        ref_cfg = dataclasses.replace(ref_cfg, max_scatterers=size)
        cfg = dataclasses.replace(cfg, max_scatterers=size)
        want = jsyn.pipeline_scatterer_pad(jbatch, ref_cfg)
        got = pipeline_scatterer_pad(batch, cfg)
        for name, w in want._asdict().items():
            g = to_np(getattr(got, name))
            assert g.dtype == np.asarray(w).dtype and g.shape == (2, size)
            np.testing.assert_array_equal(g, np.asarray(w), name)
