"""The port's loop-closure detection and SE(2) ICP
(``radar_slam_tpu_torch/parallel/loopclosure.py``) against the JAX
reference on the CPU.

Inputs are the reference's own: the two clouds of
``tests/test_slam.py``'s ICP tests, its ``circle_scene`` (a full circle
with a revisit) and the aliased corridor of
``io/synthetic.py:periodic_corridor_scene``.  Tolerances: ICP poses and
RMSE 1e-4, inlier counts equal; loop lists the same (i, j) in the same
order, deltas 1e-4, inliers equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_slam_tpu.io import synthetic as jsyn
from radar_slam_tpu.parallel import loopclosure as jlc
from radar_slam_tpu_torch.parallel import loopclosure as tlc
from tests.test_slam import circle_scene, random_cloud


def t(x):
    return torch.from_numpy(np.array(x))


def icp_clouds(case):
    """The clouds of test_icp_recovers_known_transform and
    test_icp_partial_overlap_and_masks, with their settings."""
    if case == "known_transform":
        rng = np.random.default_rng(0)
        dst = random_cloud(rng)
        true = np.array([1.2, -0.8, 0.15], np.float32)
        c, s = np.cos(true[2]), np.sin(true[2])
        R = np.array([[c, -s], [s, c]])
        src = ((dst - true[:2]) @ R).astype(np.float32)
        src = src + rng.normal(0, 0.03, src.shape).astype(np.float32)
        sv = dv = np.ones(len(src), bool)
        return src, sv, dst, dv, dict(iters=10, gate=3.0)
    rng = np.random.default_rng(1)
    dst = random_cloud(rng, n=50)
    src = dst.copy()
    src[:20] = rng.uniform(-60, 60, (20, 2))
    sv = np.ones(50, bool)
    dv = np.ones(50, bool)
    dv[45:] = False
    return src.astype(np.float32), sv, dst, dv, dict(iters=8, gate=1.5)


@pytest.mark.parametrize("case", ["known_transform", "partial_overlap"])
def test_icp_matches_reference(case):
    src, sv, dst, dv, kw = icp_clouds(case)
    want = jlc.icp_se2(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst),
                       jnp.asarray(dv), jnp.zeros(3), **kw)
    got = tlc.icp_se2(t(src), t(sv), t(dst), t(dv), torch.zeros(3), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-4)
    assert int(got[2]) == int(want[2])
    assert got[2].dtype == torch.int32


def test_icp_batched_over_leading_axes_equals_single_runs():
    """Candidates x inits on leading axes (the scan-context verifier's
    layout) give each pair's single run."""
    clouds = [icp_clouds(c) for c in ("known_transform", "partial_overlap")]
    K = 50
    pad = [tuple(np.concatenate([a, np.zeros((K - len(a),) + a.shape[1:],
                                                a.dtype)]) for a in c[:4])
           for c in clouds]
    src, sv, dst, dv = (t(np.stack([p[k] for p in pad])) for k in range(4))
    inits = t(np.array([[[0, 0, 0], [1.0, -0.5, 0.1]]] * 2, np.float32))
    pose, rmse, n = tlc.icp_se2(src[:, None], sv[:, None], dst[:, None],
                                dv[:, None], inits, iters=8, gate=2.0)
    assert pose.shape == (2, 2, 3) and n.shape == (2, 2)
    for p in range(2):
        for i in range(2):
            one = tlc.icp_se2(src[p], sv[p], dst[p], dv[p], inits[p, i],
                              iters=8, gate=2.0)
            np.testing.assert_allclose(pose[p, i].numpy(), one[0].numpy(),
                                       atol=1e-6)
            assert int(n[p, i]) == int(one[2])


def same_loops(got, want, delta_tol=1e-4):
    assert [(lc["i"], lc["j"]) for lc in got] == \
        [(lc["i"], lc["j"]) for lc in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["delta"], np.asarray(b["delta"]),
                                   atol=delta_tol)
        assert a["inliers"] == b["inliers"]
        assert abs(a["rmse"] - b["rmse"]) < 1e-4


@pytest.mark.parametrize("kw", [
    dict(revisit_radius=4.0, min_separation=40),
    dict(revisit_radius=6.0, min_separation=40, max_rmse=1.0),
    dict(revisit_radius=12.0, min_separation=30, max_candidates=4)])
def test_find_loop_closures_on_circle_matches_reference(kw):
    poses, pts, msk = circle_scene()
    want = jlc.find_loop_closures(pts, msk, poses,
                                  jlc.LoopClosureConfig(**kw))
    got = tlc.find_loop_closures(t(pts), t(msk), poses,
                                 tlc.LoopClosureConfig(**kw))
    assert want, "the circle's revisit is found"
    same_loops(got, want)


def test_find_loop_closures_on_corridor_matches_reference():
    """A straight corridor with a pose gate wide enough to admit pairs 20
    frames apart: the aliased candidates and their verdicts agree."""
    poses, pts, msk = jsyn.periodic_corridor_scene(0, n_frames=60,
                                                   jitter=0.35)
    kw = dict(revisit_radius=13.0, min_separation=20)
    want = jlc.find_loop_closures(pts, msk, poses,
                                  jlc.LoopClosureConfig(**kw))
    got = tlc.find_loop_closures(t(pts), t(msk), poses,
                                 tlc.LoopClosureConfig(**kw))
    same_loops(got, want)


def test_relative_pose_and_config_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(4):
        a, b = rng.normal(size=(2, 3)) * [10, 10, 2]
        np.testing.assert_array_equal(tlc._relative_pose(a, b),
                                      jlc._relative_pose(a, b))
    import dataclasses
    assert dataclasses.asdict(tlc.LoopClosureConfig()) == \
        dataclasses.asdict(jlc.LoopClosureConfig())
