"""The port's detection / AoA / phase-B stages vs the JAX reference, stage by
stage on the SAME inputs.

The inputs are realistic: the port's front end (plain version, CPU) runs
the bench scene with noise once, and each stage then receives the
reference's output of the stage before it as numpy -- so every comparison
isolates one stage.  The reference vmaps single-frame functions; the port
writes the frame axis out.

Tolerances: stages that only select or count (validity, bins, keep masks,
model orders, association indices) must agree exactly; float outputs agree
to float32 rounding of a few operations (1e-5 relative scale); angles are
refined by a parabola through spectrum samples whose rounding differs by
~1e-7, hence 1e-3 deg; the velocity solve chains 3 + 3 IRLS and 8
Gauss-Newton steps on a wrapped residual, hence 1e-4 m/s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np

from radar_slam_tpu.aoa import smoothing as jsmooth
from radar_slam_tpu.core import types as jtypes
from radar_slam_tpu.evaluate import pose_metrics as jpm
from radar_slam_tpu.motion.associate import associate_targets as jassoc
from radar_slam_tpu.motion.velocity import solve_velocity as jsolve
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu_torch.aoa import smoothing as tsmooth
from radar_slam_tpu_torch.core import types as ttypes
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.evaluate import pose_metrics as tpm
from radar_slam_tpu_torch.motion.associate import associate_targets as tassoc
from radar_slam_tpu_torch.motion.velocity import solve_velocity as tsolve
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.windows import window_freq_taps
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal.rds import _mix_vector
from radar_slam_tpu_torch.signal.synth import (fast_time_base,
                                               synthesis_factors_split)

F = 6


def _np_tree(x):
    return {k: (None if v is None else to_np(v))
            for k, v in x._asdict().items()}


def _to_jax(cls, d):
    return cls(**{k: (None if v is None else jnp.asarray(v))
                  for k, v in d.items()})


def _to_torch(cls, d):
    return cls(**{k: (None if v is None else torch.tensor(v))
                  for k, v in d.items()})


def _assert_tree_close(got, ref, atol, exact=(), rtol=1e-6, loose=None):
    """Exact for masks / integers / ``exact`` keys, else atol + rtol;
    ``loose`` maps keys to their own (rtol, atol)."""
    for k, r in ref.items():
        if r is None:
            assert got[k] is None, k
            continue
        g = got[k]
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if k in exact or r.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            ok = np.isfinite(r)
            np.testing.assert_array_equal(np.isfinite(g), ok, err_msg=k)
            rt, at = (loose or {}).get(k, (rtol, atol))
            np.testing.assert_allclose(g[ok], r[ok], rtol=rt, atol=at,
                                       err_msg=k)


@pytest.fixture(scope="module")
def stages():
    """Reference stage outputs (numpy), each computed from the previous
    reference stage, starting from the port's front-end outputs."""
    cfg = bench_config()
    _, fields, gt = scene_fields(F)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    seeds = tframe.frame_seeds(torch.Generator().manual_seed(3), F, "cpu")
    d = cfg.detection
    S, C = cfg.radar.samples_per_chirp, cfg.radar.num_chirps
    lo, hi = tdet.range_gate_bin_interval(cfg.radar, S, d)
    split = synthesis_factors_split(batch, cfg.radar)
    raw = fe.scatterer_frontend_split(
        split.ant, split.dopp, split.coarse, split.fine, split.tau,
        fast_time_base(cfg.radar, device="cpu"), seeds,
        _mix_vector(cfg.radar, cfg.window, "baseband", S, device="cpu"), C,
        float(cfg.radar.noise_power) ** 0.5, d.max_detections,
        train=d.cfar_train_cells, guard=d.guard_cells,
        neighborhood=d.neighborhood, offset_db=d.cfar_offset_db,
        threshold_db=d.threshold_db, min_range_bin=lo, max_range_bin=hi,
        doppler_window=cfg.doppler_window,
        noise_taps=window_freq_taps(cfg.window))
    raw = tuple(map(to_np, raw))
    s = {"cfg": cfg, "gt": gt, "raw": raw}

    s["det"] = _np_tree(jax.vmap(lambda p, r, d, v: jdet.detections_from_topk(
        p, r, d, v, cfg.radar, cfg.detection))(*map(jnp.asarray, raw[:4])))
    det_j = _to_jax(jtypes.Detections, s["det"])
    feats = jax.vmap(lambda d, sg: jframe._aoa_features(d, sg, cfg))(
        det_j, jnp.asarray(raw[4]))
    s["feats"] = [to_np(x) for x in feats[2:]]
    keep, num_src, is_multi, ang, el, conf = s["feats"]
    keys = s["det"]["range_bin"] * C + s["det"]["doppler_bin"]
    sm = jsmooth.smooth_windowed(jnp.asarray(keys), jnp.asarray(ang),
                                 jnp.asarray(conf), jnp.asarray(keep),
                                 cfg.aoa)
    s["smooth_in"] = (keys, ang, conf, keep)
    s["smooth"] = tuple(map(to_np, sm))
    ang_s, conf_s = s["smooth"]
    reliable = keep & (conf_s >= cfg.aoa.confidence_threshold) & ~is_multi
    dt = s["det"]
    tgt = dict(range_bin=dt["range_bin"], doppler_bin=dt["doppler_bin"],
               range_m=dt["range_m"], doppler_hz=dt["doppler_hz"],
               vr_mps=dt["vr_mps"], power_db=dt["power_db"],
               azimuth_rad=np.deg2rad(ang_s).astype(np.float32),
               confidence=conf_s, num_sources=num_src,
               is_multipath=is_multi, is_reliable=reliable,
               spatial_signature=raw[4], valid=keep,
               elevation_rad=np.deg2rad(el).astype(np.float32))
    s["targets"] = tgt
    prev = {k: np.concatenate([v[:1], v[:-1]]) for k, v in tgt.items()}
    s["prev"] = prev
    s["assoc"] = _np_tree(jax.vmap(lambda c, p: jassoc(
        c, p, cfg.frame_dt, cfg.velocity))(_to_jax(jtypes.Targets, tgt),
                                           _to_jax(jtypes.Targets, prev)))
    assoc_j = _to_jax(jtypes.Associations, s["assoc"])
    s["motion"] = _np_tree(jax.vmap(lambda a: jsolve(
        a, jnp.float32(cfg.frame_dt), cfg.radar.lambda_c, cfg.velocity,
        v_unambiguous=cfg.radar.max_unambiguous_velocity))(assoc_j))
    s["pose"] = to_np(jframe._pose_prefix(
        _to_jax(jtypes.MotionEstimate, s["motion"]), cfg, True))
    return s


def test_detections_from_topk_matches(stages):
    cfg, raw = stages["cfg"], stages["raw"]
    det = tdet.detections_from_topk(*map(torch.tensor, raw[:4]),
                                    cfg.radar, cfg.detection)
    assert det.valid.any()
    _assert_tree_close(_np_tree(det), stages["det"], atol=1e-4)


def test_aoa_features_match(stages):
    cfg = stages["cfg"]
    det = _to_torch(ttypes.Detections, stages["det"])
    got = [to_np(x) for x in tframe._aoa_features(
        det, torch.tensor(stages["raw"][4]), cfg)[2:]]
    keep, num_src, is_multi, ang, el, conf = stages["feats"]
    np.testing.assert_array_equal(got[0], keep)
    np.testing.assert_array_equal(got[1], num_src)
    np.testing.assert_array_equal(got[2], is_multi)
    np.testing.assert_allclose(got[3][keep], ang[keep], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[4], el)
    np.testing.assert_allclose(got[5], conf, rtol=0, atol=1e-5)


def test_smooth_windowed_matches(stages):
    cfg = stages["cfg"]
    keys, ang, conf, keep = stages["smooth_in"]
    got = tsmooth.smooth_windowed(*map(torch.tensor,
                                       (keys, ang, conf, keep)), cfg.aoa)
    np.testing.assert_allclose(to_np(got[0]), stages["smooth"][0], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got[1]), stages["smooth"][1], rtol=0,
                               atol=1e-6)


def test_smooth_windowed_chains_tracks():
    """Planted track chains with gaps <= track_max_age + 1 (and one gap
    beyond it) smooth exactly as the reference's windowed gather."""
    cfg = bench_config()
    rng = np.random.default_rng(1)
    Fn, K = 12, 10
    keys = rng.integers(0, 6, size=(Fn, K)).astype(np.int32)
    keys[5:8, 0] = 999                      # a short chain
    keys[:, 1] = 555                        # a chain in every frame
    keys[[0, 4], 2] = 777                   # gap of 4 frames: no link
    ang = rng.uniform(-60, 60, (Fn, K)).astype(np.float32)
    conf = rng.uniform(0, 1, (Fn, K)).astype(np.float32)
    conf[3, 1] = 0.0
    valid = rng.random((Fn, K)) < 0.8
    valid[:, 1] = True
    ref = jsmooth.smooth_windowed(*map(jnp.asarray, (keys, ang, conf,
                                                     valid)), cfg.aoa)
    got = tsmooth.smooth_windowed(*map(torch.tensor, (keys, ang, conf,
                                                          valid)), cfg.aoa)
    np.testing.assert_allclose(to_np(got[0]), to_np(ref[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got[1]), to_np(ref[1]), rtol=0,
                               atol=1e-6)


def test_mdl_model_order_matches_on_general_spectra():
    """The pipeline feeds MDL rank-1 spectra (always one source); general
    descending spectra exercise the criterion itself."""
    from radar_slam_tpu.aoa.confidence import mdl_model_order as jmdl
    from radar_slam_tpu_torch.aoa.confidence import mdl_model_order as tmdl
    rng = np.random.default_rng(4)
    ev = np.sort(rng.exponential(1.0, (5, 40, 8)), axis=-1)[..., ::-1]
    ev[:, :5, 1:] *= 1e-8                          # rank-1 guard rows
    ev[:, 5:10] = 0.0                              # all-zero spectra
    ev = np.ascontiguousarray(ev, dtype=np.float32)
    got = tmdl(torch.tensor(ev))
    ref = jax.vmap(jmdl)(jnp.asarray(ev))
    np.testing.assert_array_equal(to_np(got[0]), to_np(ref[0]))
    np.testing.assert_array_equal(to_np(got[1]), to_np(ref[1]))
    np.testing.assert_allclose(to_np(got[2]), to_np(ref[2]), rtol=1e-5)


def test_unported_methods_raise(stages):
    import dataclasses
    from radar_slam_tpu_torch.aoa.estimators import estimate_angles
    cfg = stages["cfg"]
    sigs = torch.tensor(stages["raw"][4])
    for method in ("music", "esprit"):
        with pytest.raises(NotImplementedError):
            estimate_angles(sigs, cfg.radar, cfg.aoa, method)
    greedy = dataclasses.replace(cfg.velocity, association_method="greedy")
    tgt = _to_torch(ttypes.Targets, stages["targets"])
    with pytest.raises(NotImplementedError):
        tassoc(tgt, tgt, cfg.frame_dt, greedy)


def test_associate_targets_matches(stages):
    cfg = stages["cfg"]
    got = tassoc(_to_torch(ttypes.Targets, stages["targets"]),
                 _to_torch(ttypes.Targets, stages["prev"]), cfg.frame_dt,
                 cfg.velocity)
    ref = stages["assoc"]
    assert ref["valid"].sum() > 10
    _assert_tree_close(_np_tree(got), ref, atol=1e-4,
                       exact=("prev_index", "valid"))


@pytest.mark.parametrize("mode", ["fused", "doppler", "phase"])
def test_solve_velocity_matches(stages, mode):
    """All three observables of the solve (the pipeline runs "fused": the
    Doppler IRLS seeding the phase Gauss-Newton)."""
    cfg = stages["cfg"]
    got = tsolve(_to_torch(ttypes.Associations, stages["assoc"]),
                 cfg.frame_dt, cfg.radar.lambda_c, cfg.velocity, mode=mode,
                 v_unambiguous=cfg.radar.max_unambiguous_velocity)
    ref = (stages["motion"] if mode == "fused" else _np_tree(jax.vmap(
        lambda a: jsolve(a, jnp.float32(cfg.frame_dt), cfg.radar.lambda_c,
                         cfg.velocity, mode=mode,
                         v_unambiguous=cfg.radar.max_unambiguous_velocity))(
            _to_jax(jtypes.Associations, stages["assoc"]))))
    assert ref["success"][1:].all()
    # The phase residual subtracts a ~2.6e3 rad model phase, whose float32
    # ulp is 2.4e-4 rad: the residual statistics carry that rounding.
    res_tol = (1e-3, 1e-3)
    _assert_tree_close(_np_tree(got), ref, atol=1e-4,
                       exact=("success", "num_targets"),
                       loose={"rmse": res_tol, "max_residual": res_tol,
                              "cost": res_tol})


def test_pose_prefix_and_pose_errors_match(stages):
    cfg, gt = stages["cfg"], stages["gt"]
    motion = _to_torch(ttypes.MotionEstimate, stages["motion"])
    for rotate in (True, False):
        got = to_np(tframe._pose_prefix(motion, cfg, rotate))
        ref = to_np(jframe._pose_prefix(
            _to_jax(jtypes.MotionEstimate, stages["motion"]), cfg, rotate))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    pose = stages["pose"]
    vel = stages["motion"]["velocity"]
    ref = jpm.planar_pose_errors(pose, gt["poses"], vel,
                                 np.tile(gt["velocity_body"], (F, 1)))
    got = tpm.planar_pose_errors(torch.tensor(pose), gt["poses"], vel,
                                 np.tile(gt["velocity_body"], (F, 1)))
    assert got == ref
