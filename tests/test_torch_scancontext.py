"""The port's scan-context retrieval (``radar_slam_tpu_torch/parallel/
scancontext.py``) and the loop-closure scenes of ``io/synthetic.py``
against the JAX reference on the CPU.

Inputs: the reference's ``circle_scene`` (``tests/test_slam.py``), the
aliased corridor (``periodic_corridor_scene``) with and without clutter and
movers (``augment_clutter_movers``), and seeded random clouds and keys.
Tolerances: the scenes bit for bit; descriptor counts equal (the
descriptors 1e-6); ring keys and ``sc_correlate``'s similarity 1e-5, its
shifts equal; stage 1 (dense, and tiled at a ``stage1_dense_limit``
lowered to force it on a small F) indices equal, values 1e-6; candidate
lists equal; ``find_loop_closures_sc`` the same (i, j), deltas 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_slam_tpu.io import synthetic as jsyn
from radar_slam_tpu.parallel import loopclosure as jlc
from radar_slam_tpu.parallel import scancontext as jsc
from radar_slam_tpu_torch.io import synthetic as tsyn
from radar_slam_tpu_torch.parallel import loopclosure as tlc
from radar_slam_tpu_torch.parallel import scancontext as tsc
from tests.test_slam import circle_scene


def t(x):
    return torch.from_numpy(np.array(x))


def counts(desc):
    return np.rint(np.expm1(np.asarray(desc, np.float64))).astype(int)


@pytest.fixture(scope="module")
def scenes():
    """(points, valid) of each scene as numpy, made once by the
    reference."""
    out = {}
    _, p, m = circle_scene()
    out["circle"] = (np.asarray(p), np.asarray(m))
    for jitter in (0.0, 0.35):
        poses, p, m = jsyn.periodic_corridor_scene(1, n_frames=80,
                                                   jitter=jitter)
        out[f"corridor{jitter}"] = (np.asarray(p), np.asarray(m))
    p, m = jsyn.augment_clutter_movers(poses, p, m, 101,
                                       clutter_per_frame=12, n_movers=3)
    out["corridor_clutter"] = (np.asarray(p), np.asarray(m))
    return out


@pytest.mark.parametrize("jitter", [0.0, 0.35, 0.6])
def test_corridor_scenes_match_reference_bit_for_bit(jitter):
    want = jsyn.periodic_corridor_scene(2, n_frames=40, jitter=jitter)
    got = tsyn.periodic_corridor_scene(2, n_frames=40, jitter=jitter,
                                       device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    wp, wm = jsyn.augment_clutter_movers(want[0], want[1], want[2], 7,
                                         clutter_per_frame=5, n_movers=2)
    gp, gm = tsyn.augment_clutter_movers(got[0], got[1], got[2], 7,
                                         clutter_per_frame=5, n_movers=2)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gp.dtype == torch.float32 and gm.dtype == torch.bool


def test_descriptors_match_reference_on_bin_edges():
    """Points on ring and sector edges, inside min_range, at max_range,
    behind the sensor (atan2 = +-pi) and invalid ones."""
    cfg = dataclasses.asdict(jsc.ScanContextConfig())
    R, S, rmax = cfg["n_rings"], cfg["n_sectors"], cfg["max_range"]
    r = np.concatenate([np.arange(R + 1) * rmax / R, [0.2, 0.5, 44.999]])
    a = np.concatenate([np.arange(S + 1) * 2 * np.pi / S - np.pi,
                        [np.pi, -np.pi, 0.0]])
    rr, aa = np.meshgrid(r, a)
    pts = np.stack([rr * np.cos(aa), rr * np.sin(aa)], -1).reshape(1, -1, 2)
    pts = np.concatenate([pts, -pts]).astype(np.float32)
    valid = np.random.default_rng(0).uniform(size=pts.shape[:2]) > 0.1
    want = jsc.build_descriptors(jnp.asarray(pts), jnp.asarray(valid),
                                 jsc.ScanContextConfig())
    got = tsc.build_descriptors(t(pts), t(valid), tsc.ScanContextConfig())
    np.testing.assert_array_equal(counts(got.numpy()), counts(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["circle", "corridor0.35",
                                  "corridor_clutter"])
def test_descriptors_keys_and_correlation_match_reference(scenes, name):
    p, m = scenes[name]
    want = jsc.build_descriptors(jnp.asarray(p), jnp.asarray(m),
                                 jsc.ScanContextConfig())
    got = tsc.build_descriptors(t(p), t(m), tsc.ScanContextConfig())
    np.testing.assert_array_equal(counts(got.numpy()), counts(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tsc.ring_keys(got).numpy(),
                               np.asarray(jsc.ring_keys(want)), atol=1e-5)
    # Every frame against the frame 25 later and against itself rolled.
    F = got.shape[0]
    a, b = np.arange(F - 25), np.arange(25, F)
    for ga, gb, wa, wb in ((got[a], got[b], want[a], want[b]),
                           (got, torch.roll(got, 7, -1), want,
                            jnp.roll(want, 7, -1))):
        ws, wk = jsc.sc_correlate(wa, wb)
        gs, gk = tsc.sc_correlate(ga, gb)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))


def test_fft_correlation_and_yaw_match_reference():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 2, (5, 16, 48)).astype(np.float32)
    b = rng.uniform(0, 2, (5, 16, 48)).astype(np.float32)
    a[0, :, :30] = 0.0                       # too few occupied sectors
    ws, wk = jsc.sc_correlate(jnp.asarray(a), jnp.asarray(b), 20)
    gs, gk = tsc.sc_correlate(t(a), t(b), 20)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    shifts = np.arange(-48, 97)
    np.testing.assert_allclose(
        tsc.shift_to_yaw(t(shifts), 48).numpy(),
        np.asarray(jsc.shift_to_yaw(jnp.asarray(shifts), 48)), atol=1e-6)


@pytest.mark.parametrize("F,tile,min_sep,top_m", [
    (97, 16, 20, 4), (256, 64, 5, 8), (33, 64, 10, 3), (130, 128, 128, 4)])
def test_stage1_dense_and_tiled_match_reference(F, tile, min_sep, top_m):
    """The reference's own cases (test_stage1_tiled_matches_dense_exactly),
    with a third of the keys zero (frames with no detections: whole rows
    tie at 0, where the smaller index must come first)."""
    rng = np.random.default_rng(0)
    raw = rng.uniform(0.0, 1.0, (F, 16)).astype(np.float32)
    raw[rng.uniform(size=F) < 0.3] = 0.0
    keys = raw / np.maximum(np.linalg.norm(raw, axis=1, keepdims=True),
                            1e-9)
    dv, di = jsc._stage1_candidates(jnp.asarray(keys), top_m, min_sep)
    fin = np.isfinite(np.asarray(dv))
    for got_v, got_i in (tsc._stage1_candidates(t(keys), top_m, min_sep),
                         tsc._stage1_candidates_tiled(t(keys), top_m,
                                                      min_sep, tile)):
        np.testing.assert_array_equal(np.isfinite(got_v.numpy()), fin)
        np.testing.assert_array_equal(got_i.numpy()[fin],
                                      np.asarray(di)[fin])
        np.testing.assert_allclose(got_v.numpy()[fin], np.asarray(dv)[fin],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["circle", "corridor0.35",
                                  "corridor_clutter"])
@pytest.mark.parametrize("route", ["dense", "tiled"])
def test_propose_candidates_matches_reference(scenes, name, route):
    p, m = scenes[name]
    over = dict(min_separation=20)
    if route == "tiled":
        over.update(stage1_dense_limit=8, stage1_tile=16)
    want_cfg = jsc.ScanContextConfig(**over)
    got_cfg = tsc.ScanContextConfig(**over)
    desc = jsc.build_descriptors(jnp.asarray(p), jnp.asarray(m), want_cfg)
    want = jsc.propose_candidates(desc, want_cfg)
    got = tsc.propose_candidates(t(desc), got_cfg)
    assert want
    assert [(c["i"], c["j"]) for c in got] == [(c["i"], c["j"])
                                               for c in want]
    for a, b in zip(got, want):
        assert abs(a["sim"] - b["sim"]) < 1e-5
        assert abs(a["yaw"] - b["yaw"]) < 1e-6


@pytest.mark.parametrize("route", ["dense", "tiled"])
def test_propose_candidates_on_exact_repeats_matches_reference(scenes,
                                                                route):
    """Without jitter the corridor repeats exactly, so every candidate's
    similarity is 1 up to float rounding, and their order is the order of
    rounding errors (the FFTs round otherwise): the lists agree in length
    and in similarity."""
    p, m = scenes["corridor0.0"]
    over = dict(min_separation=20)
    if route == "tiled":
        over.update(stage1_dense_limit=8, stage1_tile=16)
    desc = jsc.build_descriptors(jnp.asarray(p), jnp.asarray(m),
                                 jsc.ScanContextConfig(**over))
    want = jsc.propose_candidates(desc, jsc.ScanContextConfig(**over))
    got = tsc.propose_candidates(t(desc), tsc.ScanContextConfig(**over))
    assert len(got) == len(want) == 16
    np.testing.assert_allclose([c["sim"] for c in got],
                               [c["sim"] for c in want], atol=1e-5)
    assert all(c["j"] - c["i"] >= 20 for c in got)


def test_retrieval_is_temporally_gated():
    _, pts, msk = circle_scene(n_frames=30)
    desc = tsc.build_descriptors(t(pts), t(msk), tsc.ScanContextConfig())
    assert tsc.propose_candidates(
        desc, tsc.ScanContextConfig(min_separation=40)) == []


@pytest.mark.parametrize("name,with_poses", [
    ("circle", True), ("circle", False), ("corridor0.35", True),
    ("corridor_clutter", True)])
def test_find_loop_closures_sc_matches_reference(scenes, name, with_poses):
    p, m = scenes[name]
    F = p.shape[0]
    if name == "circle":
        poses = circle_scene()[0]
        lc = dict(min_separation=40, max_rmse=0.5)
    else:
        poses = np.zeros((F, 3))
        poses[:, 0] = 0.6 * np.arange(F)
        lc = dict(min_separation=20)
    poses = poses if with_poses else None
    want = jsc.find_loop_closures_sc(jnp.asarray(p), jnp.asarray(m), poses,
                                     jlc.LoopClosureConfig(**lc))
    got = tsc.find_loop_closures_sc(t(p), t(m), poses,
                                    tlc.LoopClosureConfig(**lc))
    assert [(c["i"], c["j"]) for c in got] == [(c["i"], c["j"])
                                               for c in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["delta"], np.asarray(b["delta"]),
                                   atol=1e-4)
        assert a["inliers"] == b["inliers"]
        assert abs(a["rmse"] - b["rmse"]) < 1e-4
        assert abs(a["sim"] - b["sim"]) < 1e-5
