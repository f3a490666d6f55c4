"""The port's evaluation layer and profiling utilities against the JAX
package's.

``evaluate/pose_metrics.py``, ``velocity_metrics.py`` and ``reports.py``
are host numpy in float64 in both packages: the same numpy in gives the
same numpy out, bit for bit, and the same report text.  Tensors are
accepted by the port and give what their float64 numpy gives.  The
reference's timing gate (RTE on 5,000 poses under 1 s,
tests/test_evaluate.py:167) holds for the port.  ``utils/profiling.py``'s
``StageTimer``, ``benchmark`` and ``trace`` keep the reference's keys.
"""

import json
import time

import numpy as np
import pytest
import torch

from radar_slam_tpu.evaluate import pose_metrics as jpm
from radar_slam_tpu.evaluate import reports as jrep
from radar_slam_tpu.evaluate import velocity_metrics as jvm
from radar_slam_tpu.utils import profiling as jprof
from radar_slam_tpu_torch.evaluate import pose_metrics as tpm
from radar_slam_tpu_torch.evaluate import reports as trep
from radar_slam_tpu_torch.evaluate import velocity_metrics as tvm
from radar_slam_tpu_torch.utils import profiling as tprof


def rand_traj(n=60, seed=0, noise=0.0):
    """(x, y, z, qw, qx, qy, qz) poses of a curving drive, optionally with
    position noise and a small roll / pitch wobble."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 10, n)
    pos = np.stack([10 * t, 5 * np.sin(0.3 * t), 0.05 * t], axis=1)
    pos = pos + rng.normal(0, noise, pos.shape)
    yaw = 0.1 * t + rng.normal(0, noise, n)
    roll = rng.normal(0, 0.02, n)
    q = np.stack([np.cos(yaw / 2) * np.cos(roll / 2),
                  np.sin(roll / 2) * np.cos(yaw / 2),
                  -np.sin(roll / 2) * np.sin(yaw / 2),
                  np.sin(yaw / 2) * np.cos(roll / 2)], axis=1)
    return np.column_stack([pos, q])


def equal(a, b):
    """Recursive bit-for-bit equality of numpy trees (dicts, tuples,
    arrays, floats)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def pose_metric_args(name):
    est, gt = rand_traj(80, seed=1, noise=0.05), rand_traj(80, seed=0)
    q1, q2 = est[:, 3:], gt[:, 3:]
    return {
        "_q_mul": (q1, q2), "_q_conj": (q1,), "_q_norm": (q1 * 1.7,),
        "_q_angle": (q1,), "_q_mean": (q1,), "_q_to_matrix": (q1[5],),
        "umeyama_alignment": (est[:, :3], gt[:, :3]),
        "align_orientations": (q1, q2),
        "align_trajectories": (est, gt),
        "compute_ape": (est, gt),
        "_relative_transform": (est[3, :3], est[40, :3], q1[3], q1[40]),
        "_q_rotate": (q1, est[:, :3]),
        "compute_rte": (est, gt, (20.0, 50.0)),
        "planar_pose_errors": (est[:, [0, 1, 5]], gt[:, [0, 1, 5]]),
    }[name]


@pytest.mark.parametrize("name", [
    "_q_mul", "_q_conj", "_q_norm", "_q_angle", "_q_mean", "_q_to_matrix",
    "umeyama_alignment", "align_orientations", "align_trajectories",
    "compute_ape", "_relative_transform", "_q_rotate", "compute_rte",
    "planar_pose_errors"])
def test_pose_metric_bit_for_bit(name):
    args = pose_metric_args(name)
    equal(getattr(tpm, name)(*args), getattr(jpm, name)(*args))


def test_pose_metrics_constants_and_unaligned_forms():
    assert tpm.DEFAULT_RTE_SEGMENTS == jpm.DEFAULT_RTE_SEGMENTS
    est, gt = rand_traj(300, seed=2, noise=0.1), rand_traj(300, seed=0)
    equal(tpm.compute_ape(est, gt, align=False),
          jpm.compute_ape(est, gt, align=False))
    equal(tpm.compute_rte(est, gt, align=False),
          jpm.compute_rte(est, gt, align=False))


def test_pose_metrics_take_tensors():
    """float32 tensors read back as float64 numpy: the metrics of the
    tensors are those of their float64 copies."""
    est = rand_traj(50, seed=3, noise=0.1).astype(np.float32)
    gt = rand_traj(50, seed=0).astype(np.float32)
    ape_t = tpm.compute_ape(torch.from_numpy(est), torch.from_numpy(gt))
    equal(ape_t, jpm.compute_ape(est.astype(np.float64),
                                 gt.astype(np.float64)))
    rte_t = tpm.compute_rte(torch.from_numpy(est), torch.from_numpy(gt),
                            (20.0,))
    equal(rte_t, jpm.compute_rte(est.astype(np.float64),
                                 gt.astype(np.float64), (20.0,)))


def velocity_inputs(n=50, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 1, (n, 6))
    est = gt + rng.normal(0, 0.1, (n, 6)) + 0.01 * np.arange(n)[:, None]
    return est, gt, 0.1 * np.arange(n)


@pytest.mark.parametrize("with_timestamps", [False, True])
def test_velocity_metrics_bit_for_bit(with_timestamps):
    est, gt, ts = velocity_inputs()
    ts = ts if with_timestamps else None
    got = tvm.compute_velocity_errors(est, gt, timestamps=ts)
    want = jvm.compute_velocity_errors(est, gt, timestamps=ts)
    equal(got, want)
    for window in (10, 3):
        equal(tvm.analyze_error_trends(got, window),
              jvm.analyze_error_trends(want, window))
    assert tvm.COMPONENTS == jvm.COMPONENTS


def test_velocity_metrics_take_tensors_and_check_shapes():
    est, gt, ts = velocity_inputs(20, seed=1)
    got = tvm.compute_velocity_errors(
        torch.from_numpy(est.astype(np.float32)), gt,
        timestamps=torch.from_numpy(ts))
    equal(got, jvm.compute_velocity_errors(
        est.astype(np.float32).astype(np.float64), gt, timestamps=ts))
    for bad in ((est[:, :5], gt[:, :5]), (est, gt[:-1])):
        with pytest.raises(ValueError):
            tvm.compute_velocity_errors(*bad)


def test_reports_equal_text(tmp_path):
    est, gt, ts = velocity_inputs(30, seed=2)
    res = jvm.compute_velocity_errors(est, gt, timestamps=ts)
    trends = jvm.analyze_error_trends(res)
    assert (trep.velocity_report_markdown(res, trends)
            == jrep.velocity_report_markdown(res, trends))
    assert (trep.velocity_report_markdown(res)
            == jrep.velocity_report_markdown(res))
    e, g = rand_traj(200, seed=1, noise=0.05), rand_traj(200)
    ape = jpm.compute_ape(e, g)
    rte = jpm.compute_rte(e, g, (20.0, 50.0))
    text = trep.pose_report_markdown(ape, rte)
    assert text == jrep.pose_report_markdown(ape, rte)
    assert trep.pose_report_markdown(ape) == jrep.pose_report_markdown(ape)
    trep.write_report(text, tmp_path / "t" / "pose.md")
    jrep.write_report(text, tmp_path / "j" / "pose.md")
    assert ((tmp_path / "t" / "pose.md").read_bytes()
            == (tmp_path / "j" / "pose.md").read_bytes())


def test_json_safe_and_save_json(tmp_path):
    """Same JSON bytes as the reference for numpy trees; tensors (0-d as
    scalars) serialize as their numpy."""
    e, g = rand_traj(100, seed=1, noise=0.05), rand_traj(100)
    tree = {"ape": jpm.compute_ape(e, g),
            "rte": jpm.compute_rte(e, g, (20.0,)),
            "misc": [np.float32(1.5), np.int64(3), np.bool_(True),
                     (np.arange(3), "text", None)]}
    trep.save_json(tree, tmp_path / "t" / "summary.json")
    jrep.save_json(tree, tmp_path / "j" / "summary.json")
    assert ((tmp_path / "t" / "summary.json").read_bytes()
            == (tmp_path / "j" / "summary.json").read_bytes())
    mixed = {"scalar": torch.tensor(2.5), "int": torch.tensor(7),
             "flag": torch.tensor(True),
             "vec": torch.arange(4, dtype=torch.float32),
             "nested": [torch.ones(2, 2, dtype=torch.float64)]}
    want = {"scalar": 2.5, "int": 7, "flag": True,
            "vec": [0.0, 1.0, 2.0, 3.0], "nested": [[[1.0, 1.0],
                                                    [1.0, 1.0]]]}
    assert trep._json_safe(mixed) == want
    trep.save_json(mixed, tmp_path / "m.json")
    assert json.loads((tmp_path / "m.json").read_text()) == want


def test_rte_5000_poses_under_one_second():
    """The reference's gate (tests/test_evaluate.py:167) on the port, and
    the same segments as the reference's."""
    n = 5000
    t = np.linspace(0, 500, n)
    pos = np.stack([2.0 * t, np.sin(0.05 * t), 0 * t], axis=1)
    yaw = 0.01 * t
    quat = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                     np.sin(yaw / 2)], axis=1)
    gt = np.column_stack([pos, quat])
    est = gt.copy()
    est[:, :3] += np.random.default_rng(0).normal(0, 0.1, (n, 3))
    t0 = time.perf_counter()
    rte = tpm.compute_rte(est, gt, align=False)
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"RTE took {dt:.2f}s on {n} poses"
    assert rte["rte_100m"]["num_segments"] > 4000
    equal(rte, jpm.compute_rte(est, gt, align=False))


def test_stage_timer_matches_reference_keys():
    tt, jt = tprof.StageTimer(window=3), jprof.StageTimer(window=3)
    for timer in (tt, jt):
        for s in (0.1, 0.2, 0.3, 0.4):
            timer.record("a", s)
        with timer.section("b", sync=True):
            sum(range(1000))
    equal(tt.stats()["a"], jt.stats()["a"])         # the last 3 of 4
    assert tt.stats()["a"]["count"] == 3
    assert tt.stats().keys() == jt.stats().keys()
    assert tt.stats()["b"].keys() == jt.stats()["b"].keys()
    with pytest.raises(KeyError):
        with tt.section("c"):
            raise KeyError("x")
    assert tt.stats()["c"]["count"] == 1            # timed even on error


def test_benchmark_and_trace(tmp_path):
    calls = []

    def work(x):
        calls.append(x)
        return torch.ones(8) * x

    r = tprof.benchmark(work, 2.0, warmup=2, reps=3, name="w")
    assert set(r) == set(jprof.benchmark(lambda: 0, reps=1))
    assert r["name"] == "w" and r["reps"] == 3 and r["mean_s"] >= 0
    assert len(calls) == 5
    assert tprof.benchmark(work, 1.0, reps=1)["name"] == "work"
    tprof.synchronize("cpu")                         # nothing to wait for
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]
