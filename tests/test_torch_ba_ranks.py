"""The mesh half of the port's pose-graph solvers
(``radar_slam_tpu_torch/parallel/ba.py``) on 2 and 4 gloo ranks on the
CPU, against the reference on ``make_mesh(2)`` / ``make_mesh(4)``.

- ``gauss_newton_cg(mesh=...)``, each rank a block of the factor axis: the
  reference's fixtures (tests/test_parallel.py: the 64-pose noisy chain at
  5 x 40, the z-aware chain at 5 x 30) and the two-process worker's graphs
  (tests/_distributed_worker.py: 17 poses, 20 factors with a loop, planar
  and z-aware, 5 x 40): poses within 1e-4 of the reference's, cost within
  1e-3 relative;
- ``schur_gn_step(mesh=...)``, each rank one block: one step on the
  16-pose graphs of tests/test_torch_posegraph.py (planar and z-aware; no
  loop slot, an empty one, valid loops) within 1e-4 of the reference's
  and of the port's one-process step at ``n_blocks`` = the rank count (the
  same block body; the ranks sum the boundary system in another order);
  twelve steps on the reference's loopy 64-pose graph reach GN-CG's cost
  and close its loops (tests/test_parallel.py:212-227).

Each world size is started once, by the module fixture ``ranks``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_rank_worker import run_ranks

from radar_slam_tpu.parallel import ba as jba
from radar_slam_tpu.parallel import posegraph as jpg
from radar_slam_tpu.parallel.mesh import make_mesh
from radar_slam_tpu_torch.parallel import ba as tba
from radar_slam_tpu_torch.parallel import posegraph as tpg
from tests.test_parallel import _loopy_graph, _z_graph, make_noisy_chain
from tests.test_torch_posegraph import SCHUR_GRAPHS, chain, with_loops

WORLDS = (2, 4)


def worker_graph(use_z):
    """tests/_distributed_worker.py's GN-CG graph: 17 poses, 16 chain + 4
    loop slots (5 factors a rank at 4 ranks), one loop."""
    g = _z_graph(n=17, seed=11, loop_capacity=4) if use_z else chain(
        17, 4, seed=7)
    D = g.poses.shape[-1]
    delta = [0.4, 0.1, 0.03, 0.02] if use_z else [0.4, 0.1, 0.02]
    return with_loops(g, [(2, 14, delta, np.full(D, 1e4))])


CG_GRAPHS = {
    "chain64": (lambda: make_noisy_chain(), 5, 40),
    "z16": (lambda: _z_graph(loop_capacity=1), 5, 30),
    "worker17": (lambda: worker_graph(False), 5, 40),
    "worker17_z": (lambda: worker_graph(True), 5, 40),
}


def listed(x):
    return list(x) if isinstance(x, tuple) else [x]


def arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = {}
    for name, (make, gn, cg) in CG_GRAPHS.items():
        jobs[f"cg {name}"] = ("cg", dict(graph=arrays(make()), gn_iters=gn,
                                         cg_iters=cg))
    for name, make in SCHUR_GRAPHS.items():
        jobs[f"schur {name}"] = ("schur", dict(graph=arrays(make()),
                                               steps=1))
    jobs["schur loopy64"] = ("schur", dict(graph=arrays(_loopy_graph(n=64)),
                                           steps=12))
    out = {}
    for w in WORLDS:
        res = run_ranks(jobs, w, tmp_path_factory.mktemp(f"ba{w}"))
        for r in res[1:]:
            for job in jobs:
                for a, b in zip(listed(r[job]), listed(res[0][job])):
                    np.testing.assert_array_equal(a, b)
        out[w] = res[0]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CG_GRAPHS))
def test_gauss_newton_cg_ranks_match_reference_mesh(ranks, name, world):
    make, gn, cg = CG_GRAPHS[name]
    want_p, want_c = jba.gauss_newton_cg(make(), mesh=make_mesh(world),
                                         gn_iters=gn, cg_iters=cg)
    got_p, got_c = ranks[world][f"cg {name}"]
    assert got_p.shape == want_p.shape
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=0, atol=1e-4)
    assert abs(float(got_c) - float(want_c)) <= 1e-3 * max(float(want_c),
                                                           1e-3)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(SCHUR_GRAPHS))
def test_schur_step_ranks_match_reference_mesh(ranks, name, world):
    g = SCHUR_GRAPHS[name]()
    want = np.asarray(jba.schur_gn_step(g, make_mesh(world)))
    got = ranks[world][f"schur {name}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    one = tba.schur_gn_step(tpg.posegraph_from_numpy(arrays(g), device="cpu"),
                           world)
    np.testing.assert_allclose(got, one.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_schur_ranks_close_the_loops(ranks, world):
    """tests/test_parallel.py::test_schur_with_loop_closures_converges at
    2 and 4 ranks: after twelve ranked steps the cost is within 5 % of the
    reference's GN-CG (10 x 80) and both loop residuals are closed."""
    g = _loopy_graph(n=64)
    _, c_cg = jba.gauss_newton_cg(g, mesh=None, gn_iters=10, cg_iters=80)
    poses = jnp.asarray(ranks[world]["schur loopy64"])
    c = float(jpg.total_cost(poses, g))
    assert c <= 1.05 * float(c_cg) + 1e-6, (c, float(c_cg))
    r = np.asarray(jpg.factor_residuals(poses, g))[-2:]
    assert np.linalg.norm(r, axis=1).max() < 0.05, r


def test_cg_mesh_needs_equal_factor_blocks():
    g = tpg.posegraph_from_numpy(arrays(chain(16, 2)),  # 17 factors
                               device="cpu")
    two = tba.Mesh(None, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="equal blocks"):
        tba.gauss_newton_cg(g, mesh=two)
