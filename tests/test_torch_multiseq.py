"""The port's sequence-sharded batches (``radar_slam_tpu_torch/parallel/
multiseq.py``) on 2 and 4 gloo ranks on the CPU.

- Solve phase, on tests/test_multiseq.py's stacked loopy graphs (4
  sequences of 16 poses, one active loop each): the port's stacked GN-CG
  against the reference's vmapped ``_solve_batch``, and the ranked
  ``solve_graphs_mesh`` against the reference's on ``make_mesh(2/4)``,
  within 1e-4 (tests/test_torch_posegraph.py's mesh tolerance).
- Pipeline phase: ``process_sequences_sharded`` at 2 ranks (4 sequences,
  one front-end launch a rank over its 2 x 8 frames), every sequence's
  outputs bit for bit ``process_sequence_batched`` on its generator.
- The gates of tests/test_multiseq.py at 4 ranks: the sharded batch (8
  sequences of 8 frames recover their speeds and endpoints), Schur end to
  end (8 sequences of 7 frames), and the loop-closure round trip on two
  drifted circles (loops accepted; refined endpoint error below 0.6 x the
  open loop's).

Each world size is started once, by the module fixture ``ranks``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_rank_worker import run_ranks

from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
from radar_slam_tpu.parallel import multiseq as jms
from radar_slam_tpu.parallel import posegraph as jpg
from radar_slam_tpu.parallel.mesh import make_mesh
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.parallel import ba as tba
from radar_slam_tpu_torch.parallel import posegraph as tpg
from radar_slam_tpu_torch.pipeline import frame as tframe
from tests.test_multiseq import CFG, _loopy_graphs
from tests.test_slam import circle_scene

TCFG = config_from_dict(dataclasses.asdict(CFG))
SOLVE_STEPS = 10


def sequences(M, F, speed):
    """tests/test_multiseq.py's scenes: sequence m at ``speed(m)`` m/s."""
    seqs = []
    for m in range(M):
        b, _ = constant_motion_scene(
            100 + m, num_frames=F, dt=CFG.frame_dt, v_body=(speed(m), 0.0),
            yaw_rate=0.0,
            scene=SceneConfig(num_points=48, max_range=18.0, min_range=3.0,
                              max_scatterers=CFG.max_scatterers))
        seqs.append({k: np.asarray(v) for k, v in b._asdict().items()
                     if v is not None})
    return {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}


def graph_arrays(batch):
    return {k: np.asarray(v) for k, v in batch._asdict().items()}


def drifted_circles(M=2, F=95):
    """tests/test_multiseq.py::test_refine_sequences_mesh_round_trip's
    outputs: circle scenes with a speed-scale and yaw-rate bias."""
    v_true, w_true = 6.0, 0.7
    outs, gts = [], []
    for m in range(M):
        gt_poses, pts, msk = circle_scene(n_frames=F, v=v_true, w=w_true,
                                          dt=CFG.frame_dt, seed=5 + m)
        gts.append(np.asarray(gt_poses))
        z = np.zeros(F, np.float32)
        outs.append(dict(
            velocity=np.tile([v_true * 1.03, 0.0, 0.0], (F, 1)).astype(
                np.float32),
            angular_velocity=np.stack(
                [z, z, np.full(F, w_true + 0.03, np.float32)], -1),
            rmse=z, max_residual=z, num_targets=np.zeros(F, np.int32),
            success=np.ones(F, bool), cost=z, pose=np.zeros((F, 3),
                                                            np.float32),
            num_detections=np.zeros(F, np.int32),
            num_reliable=np.zeros(F, np.int32),
            num_associations=np.zeros(F, np.int32),
            target_xy=np.asarray(pts, np.float32),
            target_valid=np.asarray(msk),
            target_z=np.zeros(np.shape(msk), np.float32)))
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}, gts


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = dataclasses.asdict(CFG)
    graphs = graph_arrays(_loopy_graphs(M=4, n=16)[0])
    solve = ("solve_graphs", dict(graphs=graphs, steps=SOLVE_STEPS))
    jobs2 = {
        "solve": solve,
        "sharded": ("sharded", dict(
            fields=sequences(4, 8, lambda m: 3.0 + 0.5 * m),
            seeds=[10 + m for m in range(4)], cfg=cfg)),
    }
    out, _ = drifted_circles()
    jobs4 = {
        "solve": solve,
        "sharded": ("sharded", dict(
            fields=sequences(8, 8, lambda m: 3.0 + 0.5 * m),
            seeds=list(range(8)), cfg=cfg)),
        "schur": ("sequences_schur", dict(
            fields=sequences(8, 7, lambda m: 3.0 + 0.4 * m),
            seeds=list(range(8)), cfg=cfg)),
        "refine": ("refine", dict(
            out=out, cfg=cfg, steps=10, loop_capacity=4,
            lc=dict(revisit_radius=5.0, min_separation=40),
            proposer="scancontext")),
    }
    res = {}
    for w, jobs in ((2, jobs2), (4, jobs4)):
        got = run_ranks(jobs, w, tmp_path_factory.mktemp(f"ms{w}"))
        for r in got[1:]:
            assert r["solve"][0].tobytes() == got[0]["solve"][0].tobytes()
        res[w] = got[0]
    return res


def test_stacked_cg_matches_reference_solve_batch():
    batch, graphs = _loopy_graphs(M=4, n=16)
    want_p, want_c = jms._solve_batch(batch, gn_iters=6, cg_iters=40)
    stacked = tpg.PoseGraph(*[torch.stack(x) for x in zip(*[
        tpg.posegraph_from_numpy(graph_arrays(g), device="cpu")
        for g in graphs])])
    got_p, got_c = tba.gauss_newton_cg(stacked, gn_iters=6, cg_iters=40)
    assert got_p.shape == (4, 16, 3) and got_c.shape == (4,)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_solve_graphs_mesh_matches_reference(ranks, world):
    batch, _ = _loopy_graphs(M=4, n=16)
    want_p, want_c = jms.solve_graphs_mesh(batch, make_mesh(world),
                                           steps=SOLVE_STEPS)
    got_p, got_c = ranks[world]["solve"]
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_c, np.asarray(want_c), rtol=1e-3,
                               atol=1e-6)


def test_sharded_pipeline_equals_batched_driver(ranks):
    fields = sequences(4, 8, lambda m: 3.0 + 0.5 * m)
    out, poses, costs = ranks[2]["sharded"]
    assert poses.shape == (4, 9, 3) and costs.shape == (4,)
    for m in range(4):
        ref = tframe.process_sequence_batched(
            scatterer_batch_from_numpy({k: v[m] for k, v in fields.items()},
                                       "cpu"),
            torch.Generator().manual_seed(10 + m), TCFG)
        for name, got, want in (
                ("pose", out.pose, ref.pose),
                ("velocity", out.motion.velocity, ref.motion.velocity),
                ("success", out.motion.success, ref.motion.success),
                ("num_reliable", out.num_reliable, ref.num_reliable),
                ("target_xy", out.target_xy, ref.target_xy)):
            np.testing.assert_array_equal(got[m], want.numpy(), err_msg=name)


def test_multiseq_sharded_gates(ranks):
    """tests/test_multiseq.py::test_multiseq_sharded's gates."""
    M, F = 8, 8
    out, poses, _ = ranks[4]["sharded"]
    assert poses.shape == (M, F + 1, 3)
    v, ok = out.motion.velocity, out.motion.success
    recovered = 0
    for m in range(M):
        if ok[m, 1:].mean() > 0.5:
            vm = v[m, 1:][ok[m, 1:]][:, 0].mean()
            recovered += abs(vm - (3.0 + 0.5 * m)) < 0.5
            d = np.linalg.norm(poses[m, -1, :2])
            assert abs(d - (3.0 + 0.5 * m) * CFG.frame_dt * F) < 1.0, (m, d)
    assert recovered >= 6, recovered


def test_multiseq_schur_end_to_end_gates(ranks):
    """tests/test_multiseq.py::test_multiseq_schur_end_to_end's gates."""
    M, F = 8, 7
    out, poses, _ = ranks[4]["schur"]
    assert poses.shape == (M, F + 1, 3)
    ok = out.motion.success
    good = sum(ok[m, 1:].mean() > 0.5 and abs(
        np.linalg.norm(poses[m, -1, :2])
        - (3.0 + 0.4 * m) * CFG.frame_dt * F) < 1.0 for m in range(M))
    assert good >= 6, good


def test_refine_sequences_mesh_round_trip(ranks):
    """tests/test_multiseq.py::test_refine_sequences_mesh_round_trip's
    gates at 4 ranks."""
    out, gts = drifted_circles()
    (poses, costs), loops = ranks[4]["refine"]
    for m in range(2):
        open_g = jpg.from_velocities(
            out["velocity"][m], out["angular_velocity"][m, :, 2],
            out["success"][m], CFG.frame_dt)
        gt_end = gts[m][-1, :2]
        open_err = np.linalg.norm(np.asarray(open_g.poses)[-2, :2] - gt_end)
        ref_err = np.linalg.norm(poses[m, -2, :2] - gt_end)
        assert len(loops[m]) >= 1, f"sequence {m}: no loop accepted"
        assert open_err > 1.5, (m, open_err)
        assert ref_err < 0.6 * open_err, (m, ref_err, open_err)
    assert np.isfinite(costs).all()
