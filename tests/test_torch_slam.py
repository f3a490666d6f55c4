"""The port's SLAM back end end to end (``radar_slam_tpu_torch/parallel/
slam.py``) against the JAX reference on the CPU, and the rule that the new
modules import nothing of JAX.

Inputs are ``tests/test_slam.py``'s: ``circle_scene`` with the odometry of
``test_refinement_corrects_drift`` (a forward bias; both proposers find
the revisit) and of ``test_scancontext_survives_drift_where_pose_gate_fails``
(a yaw-rate bias: the pose proposer finds nothing, scan context closes the
loop), and ``test_optimize_trajectory_z_aware``'s z-aware chain.  The
reference's Schur solver runs on ``make_mesh(8)`` and the port's at
``n_blocks = 8`` (and at 1 against ``make_mesh(1)``).  Tolerances: the
same loops (i, j); refined poses 1e-3 m (yaw 1e-4 rad); open-loop poses
1e-4 m; costs 1e-3 relative.
"""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_slam_tpu.parallel import slam as jslam
from radar_slam_tpu.parallel.loopclosure import LoopClosureConfig as JLC
from radar_slam_tpu.parallel.mesh import make_mesh
from radar_slam_tpu_torch.parallel import slam as tslam
from radar_slam_tpu_torch.parallel.loopclosure import LoopClosureConfig as TLC
from tests.test_slam import circle_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def odometry(case):
    """(velocities, yaw rates, loop-closure config) of the two circle
    tests."""
    poses, _, _ = circle_scene()
    n = len(poses)
    if case == "forward_bias":
        rng = np.random.default_rng(5)
        vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.15, (n, 3))
        vel[:, 0] += 0.25
        vel[:, 2] = 0.0
        wz = np.full(n, 0.7) + rng.normal(0, 0.01, n)
        return vel, wz, dict(revisit_radius=6.0, min_separation=40,
                             max_rmse=1.0)
    rng = np.random.default_rng(7)
    vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    vel[:, 2] = 0.0
    wz = np.full(n, 0.7 - 0.1) + rng.normal(0, 0.01, n)
    return vel, wz, dict(revisit_radius=5.0, min_separation=40,
                         max_rmse=0.5)


def same_result(got, want, pos_tol=1e-3):
    assert [(lc["i"], lc["j"]) for lc in got["loop_closures"]] == \
        [(lc["i"], lc["j"]) for lc in want["loop_closures"]]
    np.testing.assert_allclose(got["open_loop_poses"],
                               want["open_loop_poses"], atol=1e-4)
    gp, wp = got["poses"], np.asarray(want["poses"])
    assert gp.shape == wp.shape
    np.testing.assert_allclose(gp[:, :-1], wp[:, :-1], atol=pos_tol)
    assert np.abs(np.angle(np.exp(1j * (gp[:, -1] - wp[:, -1])))).max() \
        < 1e-4
    assert abs(got["cost"] - want["cost"]) <= 1e-3 * max(want["cost"],
                                                         1e-3)


@pytest.fixture(scope="module")
def scene():
    _, pts, msk = circle_scene()
    return pts, msk, torch.from_numpy(np.array(pts)), \
        torch.from_numpy(np.array(msk))


@pytest.mark.parametrize("case,solver,proposer", [
    ("forward_bias", "cg", "pose"), ("forward_bias", "cg", "scancontext"),
    ("forward_bias", "schur", "pose"),
    ("forward_bias", "schur", "scancontext"),
    ("yaw_bias", "cg", "pose"), ("yaw_bias", "cg", "scancontext"),
    ("yaw_bias", "schur", "scancontext")])
def test_refine_trajectory_matches_reference(scene, case, solver, proposer):
    pts, msk, tpts, tmsk = scene
    vel, wz, lc = odometry(case)
    n = len(vel)
    want = jslam.refine_trajectory(
        vel, wz, np.ones(n, bool), 0.1, frame_points=pts, frame_valid=msk,
        lc_cfg=JLC(**lc), solver=solver, proposer=proposer,
        mesh=make_mesh(8) if solver == "schur" else None)
    got = tslam.refine_trajectory(
        vel, wz, np.ones(n, bool), 0.1, frame_points=tpts, frame_valid=tmsk,
        lc_cfg=TLC(**lc), solver=solver, proposer=proposer, n_blocks=8)
    same_result(got, want)
    # The reference's own outcomes (tests/test_slam.py,
    # tests/test_scancontext.py): the yaw bias defeats the pose gate.
    assert bool(got["loop_closures"]) == (case == "forward_bias"
                                          or proposer == "scancontext")
    assert got["graph"].poses.shape[0] == (96 if solver == "schur"
                                           else n + 1)


def test_refine_trajectory_schur_one_block_matches_reference(scene):
    """n_blocks = 1: the reference on one device (make_mesh(1)), the
    CLI's form; no keyframe padding."""
    pts, msk, tpts, tmsk = scene
    vel, wz, lc = odometry("forward_bias")
    n = len(vel)
    want = jslam.refine_trajectory(
        vel, wz, np.ones(n, bool), 0.1, frame_points=pts, frame_valid=msk,
        lc_cfg=JLC(**lc), solver="schur", mesh=make_mesh(1))
    got = tslam.refine_trajectory(
        vel, wz, np.ones(n, bool), 0.1, frame_points=tpts, frame_valid=tmsk,
        lc_cfg=TLC(**lc), solver="schur", n_blocks=1)
    same_result(got, want)


@pytest.mark.parametrize("solver", ["cg", "schur"])
def test_refine_trajectory_z_aware_matches_reference(solver):
    """test_optimize_trajectory_z_aware's chain (no loop closures), and the
    circle with its loops lifted into the z-aware graph."""
    rng = np.random.default_rng(3)
    F = 24
    v = np.tile(np.array([5.0, 0.0, 0.25], np.float32), (F, 1))
    v += rng.normal(0, 0.02, v.shape).astype(np.float32)
    wz = np.full(F, 0.05, np.float32)
    mesh = make_mesh(8) if solver == "schur" else None
    want = jslam.refine_trajectory(v, wz, np.ones(F, bool), dt=0.1,
                                   use_z=True, solver=solver, mesh=mesh)
    got = tslam.refine_trajectory(v, wz, np.ones(F, bool), dt=0.1,
                                  use_z=True, solver=solver, n_blocks=8,
                                  device="cpu")
    same_result(got, want)
    assert got["poses"].shape == (F + 1, 4)

    _, pts, msk = circle_scene()
    vel, wz, lc = odometry("forward_bias")
    vel[:, 2] = 0.1
    n = len(vel)
    want = jslam.refine_trajectory(
        vel, wz, np.ones(n, bool), 0.1, frame_points=pts, frame_valid=msk,
        lc_cfg=JLC(**lc), use_z=True, solver=solver, mesh=mesh)
    got = tslam.refine_trajectory(
        vel, wz, np.ones(n, bool), 0.1,
        frame_points=torch.from_numpy(np.array(pts)),
        frame_valid=torch.from_numpy(np.array(msk)), lc_cfg=TLC(**lc),
        use_z=True, solver=solver, n_blocks=8)
    assert got["loop_closures"]
    same_result(got, want)


def test_propose_weighted_loops_and_refine_sequence_output(scene):
    """The loop weights (ICP quality, lever arm) and the FrameOutput entry:
    velocities, yaw rates and success read from ``out.motion``, clouds
    from ``target_xy`` / ``target_valid``; one failed frame."""
    pts, msk, tpts, tmsk = scene
    poses, _, _ = circle_scene()
    _, want_w = jslam.propose_weighted_loops(pts, msk, poses, JLC(
        revisit_radius=6.0, min_separation=40))
    _, got_w = tslam.propose_weighted_loops(tpts, tmsk, poses, TLC(
        revisit_radius=6.0, min_separation=40))
    assert [w[:2] for w in got_w] == [w[:2] for w in want_w] and got_w
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
        np.testing.assert_allclose(g[3], np.asarray(w[3]), rtol=1e-3)

    vel, wz, lc = odometry("forward_bias")
    n = len(vel)
    ok = np.ones(n, bool)
    ok[17] = False
    ang = np.zeros((n, 3), np.float32)
    ang[:, 2] = wz

    def output(arr, p, m):
        return SimpleNamespace(
            motion=SimpleNamespace(velocity=arr(vel.astype(np.float32)),
                                   angular_velocity=arr(ang),
                                   success=arr(ok)),
            target_xy=p, target_valid=m)

    want = jslam.refine_sequence_output(output(jnp.asarray, pts, msk), 0.1,
                                        lc_cfg=JLC(**lc))
    got = tslam.refine_sequence_output(
        output(lambda x: torch.from_numpy(np.array(x)), tpts, tmsk), 0.1,
        lc_cfg=TLC(**lc))
    same_result(got, want)


def test_targets_to_points_and_bad_options():
    rng = np.random.default_rng(0)
    r = rng.uniform(1, 40, (3, 5))
    az = rng.uniform(-1, 1, (3, 5))
    v = rng.uniform(size=(3, 5)) > 0.3
    wp, wv = jslam.targets_to_points(r, az, v)
    gp, gv = tslam.targets_to_points(r, az, v, device="cpu")
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-6)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    vel = np.zeros((4, 3))
    with pytest.raises(ValueError, match="solver"):
        tslam.refine_trajectory(vel, np.zeros(4), np.ones(4, bool), 0.1,
                                solver="dense", device="cpu")
    with pytest.raises(ValueError, match="proposer"):
        tslam.refine_trajectory(vel[:3], np.zeros(3), np.ones(3, bool), 0.1,
                                frame_points=gp, frame_valid=gv,
                                proposer="gps")


def test_parallel_modules_import_and_run_without_jax():
    """A process where ``jax`` and the JAX package cannot be imported
    imports every module of ``radar_slam_tpu_torch.parallel`` (the SLAM
    back end's five and, since the multi-process back ends, ``mesh``,
    ``distributed``, ``dp`` and ``multiseq``) and refines a small circle
    with both solvers and both proposers on the CPU."""
    script = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = ("jax", "jaxlib", "radar_slam_tpu")

        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked in this process")
                return None

        sys.meta_path.insert(0, NoJax())
        import radar_slam_tpu_torch.parallel as par
        mods = [m.name for m in pkgutil.walk_packages(
            par.__path__, par.__name__ + ".")]
        for m in mods:
            importlib.import_module(m)

        import numpy as np, torch
        from radar_slam_tpu_torch.io.synthetic import (
            augment_clutter_movers, periodic_corridor_scene)
        from radar_slam_tpu_torch.parallel.loopclosure import (
            LoopClosureConfig)
        from radar_slam_tpu_torch.parallel.slam import refine_trajectory
        n, dt, w = 90, 0.1, 0.7
        yaw = w * dt * np.arange(n)
        step = 6.0 * dt * np.stack([np.cos(yaw), np.sin(yaw)], -1)
        xy = np.concatenate([np.zeros((1, 2)), np.cumsum(step, 0)[:-1]])
        rng = np.random.default_rng(2)
        ang = rng.uniform(0, 2 * np.pi, 120)
        rad = 6.0 / w + rng.uniform(-12, 12, 120)
        world = np.array([0, 6.0 / w]) + np.stack(
            [rad * np.sin(ang), -rad * np.cos(ang)], -1)
        pts, msk = [], []
        for (x, y), a in zip(xy, yaw):
            c, s = np.cos(a), np.sin(a)
            rel = world - [x, y]
            body = np.stack([c * rel[:, 0] + s * rel[:, 1],
                             -s * rel[:, 0] + c * rel[:, 1]], -1)
            r = np.hypot(body[:, 0], body[:, 1])
            az = np.arctan2(body[:, 1], body[:, 0])
            pts.append(body.astype(np.float32))
            msk.append((r > 1.5) & (r < 40.0) & (np.abs(az) < 1.2))
        pts, msk = torch.from_numpy(np.stack(pts)), torch.from_numpy(
            np.stack(msk))
        vel = np.tile([6.25, 0.0, 0.0], (n, 1))
        lc = LoopClosureConfig(revisit_radius=6.0, min_separation=40,
                               max_rmse=1.0)
        for solver in ("cg", "schur"):
            for proposer in ("pose", "scancontext"):
                res = refine_trajectory(
                    vel, np.full(n, w), np.ones(n, bool), dt,
                    frame_points=pts, frame_valid=msk, lc_cfg=lc,
                    solver=solver, proposer=proposer, n_blocks=2)
                assert res["loop_closures"], (solver, proposer)
                assert np.isfinite(res["poses"]).all()
        poses, p, m = periodic_corridor_scene(0, 30, device="cpu")
        p, m = augment_clutter_movers(poses, p, m, 1)
        assert p.shape == (30, 175, 2)
        assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
        print("MODULES", len(mods))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split("MODULES")[-1]) == 9, res.stdout
