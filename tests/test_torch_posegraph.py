"""The port's pose graph and its Gauss-Newton solvers
(``radar_slam_tpu_torch/parallel/{posegraph,ba}.py``) against the JAX
reference on the CPU.

The graphs are the reference's own fixtures (``tests/test_parallel.py``:
the noisy chain, the loopy graph with two fabricated loops, the z-aware
chain) and small chains built the same way, handed to the port through
``posegraph_from_numpy``.  Tolerances:

- graph construction, residuals, Jacobians, cost and the block primitives:
  1e-6 of the largest reference value;
- one ``gauss_newton_cg`` run (5 x 40 on the chain; 10 x 60 with loops):
  poses 1e-3 m / 1e-4 rad, cost 1e-3 relative;
- ``schur_gn_step`` at ``n_blocks`` 1 and 8 against the reference on
  ``make_mesh(1)`` and ``make_mesh(8)``: 1e-4, on 16-pose graphs (planar
  and z-aware, with no loop slot, an empty one, and valid loops).  Both
  solve in float32 with LU, so their difference grows with the graph's
  condition number: on a 32-pose chain with two loops (condition ~1e8) both
  sit 1e-4 to 6e-4 from the float64 step, and so apart from each other.
  There, and on the reference's loopy graph, the port is held to the
  float64 damped-GN step at the reference's own 2e-3
  (``tests/test_parallel.py::test_schur_loopy_step_equals_dense_gn_step``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_slam_tpu.parallel import ba as jba
from radar_slam_tpu.parallel import posegraph as jpg
from radar_slam_tpu.parallel.mesh import make_mesh
from radar_slam_tpu_torch.parallel import ba as tba
from radar_slam_tpu_torch.parallel import posegraph as tpg
from tests.test_parallel import _loopy_graph, _z_graph, make_noisy_chain


def to_torch(g):
    return tpg.posegraph_from_numpy({k: np.asarray(v)
                                     for k, v in g._asdict().items()},
                                    device="cpu")


def rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


def chain(n, cap, drift=0.05, seed=0):
    """make_noisy_chain with ``cap`` loop slots (0: L = 0)."""
    rng = np.random.default_rng(seed)
    v = np.tile(np.array([5.0, 0.0, 0.0]), (n - 1, 1)).astype(np.float32)
    wz = np.full(n - 1, 0.1, np.float32)
    g = jpg.from_velocities(jnp.asarray(v), jnp.asarray(wz),
                            jnp.ones(n - 1, bool), dt=0.1,
                            loop_capacity=cap)
    noisy = np.asarray(g.poses) + rng.normal(0, drift, g.poses.shape)
    return g._replace(poses=jnp.asarray(noisy.astype(np.float32)))


def with_loops(g, loops):
    for slot, (i, j, delta, info) in enumerate(loops):
        g = jpg.add_loop_closure(g, slot, i, j, jnp.asarray(delta, jnp.float32),
                                 jnp.asarray(info, jnp.float32))
    return g


GRAPHS = {
    "chain64": lambda: make_noisy_chain(n=64, drift=0.05),
    "loopy16": lambda: _loopy_graph(n=16, drift=0.05),
    "z16": lambda: _z_graph(loop_capacity=1),
    "z16_loop": lambda: with_loops(_z_graph(loop_capacity=1),
                                   [(0, 12, np.zeros(4), np.full(4, 50.0))]),
}

# 16-pose graphs for the Schur step: N divisible by 8 (B = 2 at 8 blocks).
SCHUR_GRAPHS = {
    "planar_L0": lambda: chain(16, 0),
    "planar_empty_slot": lambda: chain(16, 1),
    "planar_loops": lambda: with_loops(chain(16, 2), [
        (0, 12, np.zeros(3), np.full(3, 50.0)),
        (2, 14, [0.3, 0.1, 0.05], np.full(3, 100.0))]),
    "z_L0": lambda: _z_graph(),
    "z_empty_slot": lambda: _z_graph(loop_capacity=1),
    "z_loop": GRAPHS["z16_loop"],
}


@pytest.mark.parametrize("use_z", [False, True])
def test_from_velocities_matches_reference(use_z):
    """Chain factors, weak factors for failed frames, loop slots, the
    open-loop poses and the anchor."""
    rng = np.random.default_rng(4)
    F = 30
    v = (np.tile([5.0, 0.4, 0.3], (F, 1))
         + rng.normal(0, 0.2, (F, 3))).astype(np.float32)
    wz = (0.2 + rng.normal(0, 0.05, F)).astype(np.float32)
    ok = rng.uniform(size=F) > 0.2
    want = jpg.from_velocities(jnp.asarray(v), jnp.asarray(wz),
                               jnp.asarray(ok), 0.1, loop_capacity=3,
                               use_z=use_z)
    got = tpg.from_velocities(torch.from_numpy(v), torch.from_numpy(wz),
                              torch.from_numpy(ok), 0.1, loop_capacity=3,
                              use_z=use_z)
    assert got.poses.shape == want.poses.shape == (F + 1, 4 if use_z else 3)
    for name in ("fi", "fj", "factor_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.fi.dtype == torch.int32
    for name in ("poses", "delta", "info", "anchor", "anchor_info"):
        assert rel(getattr(got, name).numpy(), getattr(want, name)) < 1e-6, \
            name


def test_add_loop_closure_returns_a_new_graph():
    g = chain(16, 2)
    t = to_torch(g)
    before = {k: v.clone() for k, v in t._asdict().items()}
    t2 = tpg.add_loop_closure(t, 1, 3, 12, np.array([0.1, 0.2, 0.3]),
                              np.array([10.0, 20.0, 30.0]))
    g2 = jpg.add_loop_closure(g, 1, 3, 12, jnp.array([0.1, 0.2, 0.3]),
                              jnp.array([10.0, 20.0, 30.0]))
    for k, v in t._asdict().items():
        assert torch.equal(v, before[k]), k
    for k, v in t2._asdict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(g2, k)))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_residuals_jacobians_cost_match_reference(name):
    g = GRAPHS[name]()
    t = to_torch(g)
    assert rel(tpg.factor_residuals(t.poses, t).numpy(),
               jpg.factor_residuals(g.poses, g)) < 1e-6
    for got, want in zip(tpg.factor_jacobians(t.poses, t),
                         jpg.factor_jacobians(g.poses, g)):
        assert rel(got.numpy(), want) < 1e-6
    assert rel(float(tpg.total_cost(t.poses, t)),
               float(jpg.total_cost(g.poses, g))) < 1e-6


@pytest.mark.parametrize("name", list(GRAPHS))
def test_block_primitives_match_reference(name):
    """Gradient, Hessian-vector product, Jacobi diagonal and the anchor
    term, the linearization shared or rebuilt."""
    g = GRAPHS[name]()
    t = to_torch(g)
    v = np.random.default_rng(1).normal(size=g.poses.shape).astype(
        np.float32)
    lin = tba._linearize(t.poses, t)
    for got, want in (
            (tba._block_gradient(t.poses, t, lin),
             jba._block_gradient(g.poses, g)),
            (tba._block_hvp(t.poses, t, torch.from_numpy(v), lin),
             jba._block_hvp(g.poses, g, jnp.asarray(v))),
            (tba._block_hvp(t.poses, t, torch.from_numpy(v)),
             jba._block_hvp(g.poses, g, jnp.asarray(v))),
            (tba._block_diag(t.poses, t), jba._block_diag(g.poses, g)),
            (tba._anchor_terms(t.poses, t), jba._anchor_terms(g.poses, g))):
        assert rel(got.numpy(), want) < 1e-6


def test_block_primitives_drop_out_of_range_endpoints():
    """An endpoint outside [0, N) contributes nothing, as the reference's
    mode="drop" scatter; its gather clamps, as JAX's does."""
    g = chain(16, 1)
    g = g._replace(fj=g.fj.at[-1].set(40),
                   factor_valid=g.factor_valid.at[-1].set(True),
                   info=g.info.at[-1].set(jnp.full(3, 7.0)))
    t = to_torch(g)
    v = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    assert rel(tba._block_gradient(t.poses, t).numpy(),
               jba._block_gradient(g.poses, g)) < 1e-6
    assert rel(tba._block_hvp(t.poses, t, torch.from_numpy(v)).numpy(),
               jba._block_hvp(g.poses, g, jnp.asarray(v))) < 1e-6
    assert rel(tba._block_diag(t.poses, t).numpy(),
               jba._block_diag(g.poses, g)) < 1e-6


@pytest.mark.parametrize("name,iters", [
    ("chain64", (5, 40)), ("loopy16", (10, 60)), ("z16", (5, 40)),
    ("z16_loop", (10, 60))])
def test_gauss_newton_cg_matches_reference(name, iters):
    g = GRAPHS[name]()
    t = to_torch(g)
    gn, cg = iters
    want_p, want_c = jba.gauss_newton_cg(g, mesh=None, gn_iters=gn,
                                         cg_iters=cg)
    got_p, got_c = tba.gauss_newton_cg(t, gn_iters=gn, cg_iters=cg)
    want_p = np.asarray(want_p)
    got_p = got_p.numpy()
    np.testing.assert_allclose(got_p[:, :-1], want_p[:, :-1], atol=1e-3)
    dyaw = np.angle(np.exp(1j * (got_p[:, -1] - want_p[:, -1])))
    assert np.abs(dyaw).max() < 1e-4
    # The converged chains' costs are ~1e-6: relative to the start's.
    c0 = float(jpg.total_cost(g.poses, g))
    assert abs(float(got_c) - float(want_c)) <= 1e-3 * max(float(want_c),
                                                           1e-3 * c0)


@pytest.fixture(scope="module")
def schur_reference():
    """The reference's Schur step on make_mesh(1) and make_mesh(8) for
    each graph, computed once."""
    return {(name, nb): np.asarray(jba.schur_gn_step(make(), make_mesh(nb)))
            for name, make in SCHUR_GRAPHS.items() for nb in (1, 8)}


@pytest.mark.parametrize("n_blocks", [1, 8])
@pytest.mark.parametrize("name", list(SCHUR_GRAPHS))
def test_schur_gn_step_matches_reference_mesh(schur_reference, name,
                                              n_blocks):
    t = to_torch(SCHUR_GRAPHS[name]())
    got = tba.schur_gn_step(t, n_blocks).numpy()
    want = schur_reference[(name, n_blocks)]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def dense_gn_step(t, damping):
    """The damped GN step in float64, H assembled factor by factor."""
    g = t._replace(**{k: v.double() for k, v in t._asdict().items()
                      if v.is_floating_point()})
    P = g.poses
    N, D = P.shape
    r = tpg.factor_residuals(P, g)
    Ji, Jj = tpg.factor_jacobians(P, g)
    w = g.factor_valid[:, None] * g.info
    H = torch.zeros(N * D, N * D, dtype=torch.float64)
    grad = torch.zeros(N * D, dtype=torch.float64)
    for m in range(r.shape[0]):
        ends = ((int(g.fi[m]), Ji[m]), (int(g.fj[m]), Jj[m]))
        for a, Ja in ends:
            grad[a * D:(a + 1) * D] += Ja.T @ (w[m] * r[m])
            for b, Jb in ends:
                H[a * D:(a + 1) * D, b * D:(b + 1) * D] += \
                    Ja.T @ torch.diag(w[m]) @ Jb
    H[:D, :D] += torch.diag(g.anchor_info)
    grad[:D] += g.anchor_info * tpg.anchor_residual(P, g)
    H += damping * torch.eye(N * D, dtype=torch.float64)
    new = (P - torch.linalg.solve(H, grad).reshape(N, D)).numpy()
    new[:, -1] = np.arctan2(np.sin(new[:, -1]), np.cos(new[:, -1]))
    return new


@pytest.mark.parametrize("n_blocks", [1, 8])
@pytest.mark.parametrize("name", ["loopy16", "planar32_loops"])
def test_schur_gn_step_equals_dense_gn_step(name, n_blocks):
    g = (_loopy_graph(n=16, drift=0.05) if name == "loopy16" else
         with_loops(chain(32, 2), [
             (0, 28, np.zeros(3), np.full(3, 50.0)),
             (2, 30, [0.3, 0.1, 0.05], np.full(3, 100.0))]))
    t = to_torch(g)
    got = tba.schur_gn_step(t, n_blocks, damping=1e-5).numpy()
    np.testing.assert_allclose(got, dense_gn_step(t, 1e-5), atol=2e-3)
