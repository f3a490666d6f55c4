"""The port's SO(3) helpers and pose integration against the JAX reference.

- ``core/geometry.py``'s quaternion helpers on random float32 batches, the
  rotation angles including values near 0 and near pi, against the
  reference's at 1e-6 (absolute; unit quaternions, unit matrices, angles
  in radians).
- ``motion/pose.py:integrate_pose`` against the reference's ``lax.scan``
  (trapezoidal and Euler, with and without rotating the velocities,
  smoothing, an initial pose) and against a float64 sequential loop.  The
  port composes the rotations as a log-depth prefix product, the
  reference as a sequence; both normalize every combine, so the
  quaternions agree to float32 rounding (1e-6 at N = 64, their Euler
  angles 2e-6; 1e-5 at N = 2048 against the float64 loop, where the
  sequential float32 reference itself drifts ~N * eps).  Positions are a float32 cumulative sum whose
  summation order differs between XLA and torch: tolerance
  4 * N * eps32 * max |position|.
- The reference's own pose scenes (tests/test_motion.py:138-192) run on
  the port, and ``transform_to_world_frame``, ``_uniform_filter1d`` and the
  ``Trajectory`` properties are held to the reference.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter1d

from radar_slam_tpu.core import geometry as jgeo
from radar_slam_tpu.core.config import PoseConfig as JPoseConfig
from radar_slam_tpu.motion import pose as jpose
from radar_slam_tpu_torch.core import geometry as tgeo
from radar_slam_tpu_torch.core.config import PoseConfig
from radar_slam_tpu_torch.motion import pose as tpose

EPS32 = float(np.finfo(np.float32).eps)
QUAT_TOL = 1e-6
DT = 0.1


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rotvecs(rng, n):
    """Rotation vectors: random axes, angles uniform in [0, pi) plus
    angles near 0 (1e-9 .. 1e-4 rad, and exactly 0) and near pi."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0.0, np.pi, n)
    ang[:6] = [0.0, 1e-9, 1e-7, 1e-5, 1e-4, 1e-3]
    ang[6:12] = np.pi - np.array([0.0, 1e-7, 1e-5, 1e-4, 1e-3, 1e-2])
    return (axis * ang[:, None]).astype(np.float32)


def quats(rng, n):
    return np.array(jgeo.quat_from_axis_angle(jnp.asarray(rotvecs(rng, n))))


def case(name, rng):
    """(port result, reference result) of one helper on random inputs."""
    n = 64
    if name == "quat_identity":
        return tgeo.quat_identity(device="cpu"), jgeo.quat_identity()
    if name == "quat_multiply":
        a, b = quats(rng, n), quats(rng, n)[::-1].copy()
        return (tgeo.quat_multiply(t(a), t(b)),
                jgeo.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    if name == "quat_conjugate":
        a = quats(rng, n)
        return tgeo.quat_conjugate(t(a)), jgeo.quat_conjugate(jnp.asarray(a))
    if name == "quat_normalize":
        a = rng.normal(size=(n, 4)).astype(np.float32)
        a[0] = 0.0
        return tgeo.quat_normalize(t(a)), jgeo.quat_normalize(jnp.asarray(a))
    if name == "quat_from_axis_angle":
        r = rotvecs(rng, n)
        return (tgeo.quat_from_axis_angle(t(r)),
                jgeo.quat_from_axis_angle(jnp.asarray(r)))
    if name == "quat_to_rotvec":
        a = quats(rng, n)
        a[1::2] *= -1.0                       # both covers
        return tgeo.quat_to_rotvec(t(a)), jgeo.quat_to_rotvec(jnp.asarray(a))
    if name == "quat_to_matrix":
        a = quats(rng, n)
        return tgeo.quat_to_matrix(t(a)), jgeo.quat_to_matrix(jnp.asarray(a))
    if name == "matrix_to_quat":
        R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(quats(rng, n))))
        return tgeo.matrix_to_quat(t(R)), jgeo.matrix_to_quat(jnp.asarray(R))
    if name == "quat_from_euler_xyz":
        e = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
        e[:4] = [[0, 0, 0], [1e-7, -1e-7, 1e-7], [np.pi, 0, 0],
                 [0, np.pi / 2 - 1e-4, 0]]
        return (tgeo.quat_from_euler_xyz(t(e)),
                jgeo.quat_from_euler_xyz(jnp.asarray(e)))
    if name == "quat_to_euler_xyz":
        a = quats(rng, n)
        return (tgeo.quat_to_euler_xyz(t(a)),
                jgeo.quat_to_euler_xyz(jnp.asarray(a)))
    if name == "quat_rotate":
        a = quats(rng, n)
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return (tgeo.quat_rotate(t(a), t(v)),
                jgeo.quat_rotate(jnp.asarray(a), jnp.asarray(v)))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "quat_identity", "quat_multiply", "quat_conjugate", "quat_normalize",
    "quat_from_axis_angle", "quat_to_rotvec", "quat_to_matrix",
    "matrix_to_quat", "quat_from_euler_xyz", "quat_to_euler_xyz",
    "quat_rotate"])
def test_quaternion_helper_matches_reference(name):
    got, want = case(name, np.random.default_rng(zlib.crc32(name.encode())))
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=QUAT_TOL)


def test_axis_angle_round_trips_near_zero_and_pi():
    """Rotation vector -> quaternion -> rotation vector, and quaternion ->
    matrix -> quaternion, in the port: angles near 0 are exact to float32,
    and near pi the round trip stays on the rotation (up to the double
    cover)."""
    r = rotvecs(np.random.default_rng(3), 64)
    q = tgeo.quat_from_axis_angle(t(r))
    back = tgeo.quat_to_rotvec(q).numpy()
    # Near pi a rotation vector and its antipode (angle 2 pi - angle, axis
    # reversed) name the same rotation: compare the rotations.
    np.testing.assert_allclose(
        tgeo.quat_to_matrix(tgeo.quat_from_axis_angle(t(back))).numpy(),
        tgeo.quat_to_matrix(q).numpy(), rtol=0, atol=4e-6)
    np.testing.assert_allclose(back[:6], r[:6], rtol=1e-6, atol=1e-12)
    q2 = tgeo.matrix_to_quat(tgeo.quat_to_matrix(q))
    dot = torch.abs(torch.sum(q2 * q, dim=-1)).numpy()
    np.testing.assert_allclose(dot, 1.0, rtol=0, atol=1e-6)


def velocity_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 5.0, (n, 3)).astype(np.float32)
    w = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    ts = np.arange(n, dtype=np.float32) * np.float32(DT)
    return v, w, ts


def pose_pair(v, w, ts, method="trapezoidal", rotate=True, smoothing=False,
              p0=None, e0=None):
    jcfg = JPoseConfig(integration_method=method, smoothing=smoothing)
    tcfg = PoseConfig(integration_method=method, smoothing=smoothing)
    want = jpose.integrate_pose(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(ts), jcfg,
        initial_position=None if p0 is None else jnp.asarray(p0),
        initial_orientation=None if e0 is None else jnp.asarray(e0),
        rotate_velocities=rotate)
    got = tpose.integrate_pose(
        t(v), t(w), t(ts), tcfg,
        initial_position=None if p0 is None else t(p0),
        initial_orientation=None if e0 is None else t(e0),
        rotate_velocities=rotate)
    return got, want


def assert_trajectory_close(got, want, n):
    p = np.asarray(want.positions)
    pos_tol = 4 * n * EPS32 * max(np.abs(p).max(), 1.0)
    for field in got._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        # Euler angles move by up to ~2x a quaternion component's error.
        tol = {"positions": pos_tol,
               "orientations": 2 * QUAT_TOL}.get(field, QUAT_TOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=field)


@pytest.mark.parametrize("method", ["trapezoidal", "euler"])
@pytest.mark.parametrize("rotate", [True, False])
def test_integrate_pose_matches_reference(method, rotate):
    v, w, ts = velocity_inputs(64)
    got, want = pose_pair(v, w, ts, method, rotate)
    assert_trajectory_close(got, want, 64)


def test_integrate_pose_smoothing_and_initial_pose():
    v, w, ts = velocity_inputs(40, seed=1)
    got, want = pose_pair(v, w, ts, smoothing=True,
                          p0=np.array([3.0, -2.0, 0.5], np.float32),
                          e0=np.array([0.1, -0.2, 2.5], np.float32))
    assert_trajectory_close(got, want, 40)
    # A sequence no longer than the window is not smoothed, as in the
    # reference.
    got, want = pose_pair(*velocity_inputs(5), smoothing=True)
    assert_trajectory_close(got, want, 5)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_integrate_pose_short_sequences(n):
    got, want = pose_pair(*velocity_inputs(n, seed=n))
    assert_trajectory_close(got, want, n)


def float64_loop(v, w, ts):
    """The sequential composition in float64 numpy: q_i = normalize(q_{i-1}
    * dq(w_{i-1} dt)), positions by the trapezoid on rotated velocities."""
    from radar_slam_tpu.evaluate.pose_metrics import _q_mul, _q_norm, _q_rotate
    v, w, ts = (np.asarray(x, np.float64) for x in (v, w, ts))
    q = [np.array([1.0, 0.0, 0.0, 0.0])]
    for i in range(1, len(ts)):
        r = w[i - 1] * (ts[i] - ts[i - 1])
        a = np.linalg.norm(r)
        dq = np.concatenate([[np.cos(a / 2)],
                             r * (np.sin(a / 2) / a if a > 0 else 0.5)])
        q.append(_q_norm(_q_mul(q[-1], dq)))
    q = np.stack(q)
    vw = _q_rotate(q, v)
    steps = 0.5 * np.diff(ts)[:, None] * (vw[:-1] + vw[1:])
    return q, np.concatenate([np.zeros((1, 3)), np.cumsum(steps, axis=0)])


def test_integrate_pose_against_float64_loop():
    """N = 2048: the port's prefix product against the float64 sequential
    loop, next to the reference's float32 scan against the same loop."""
    n = 2048
    v, w, ts = velocity_inputs(n, seed=2)
    got, want = pose_pair(v, w, ts)
    q64, p64 = float64_loop(v, w, ts)
    err_port = np.abs(got.quaternions.numpy() - q64).max()
    err_ref = np.abs(np.asarray(want.quaternions) - q64).max()
    assert err_port < 1e-5, err_port
    assert err_ref < 1e-4, err_ref
    pos_tol = 4 * n * EPS32 * np.abs(p64).max()
    np.testing.assert_allclose(got.positions.numpy(), p64, rtol=0,
                               atol=pos_tol)


def test_prefix_product_equals_sequential_composition():
    """The log-depth product against the plain float32 left-to-right loop
    over the same quaternions, including a non-unit first element (kept as
    given)."""
    rng = np.random.default_rng(5)
    q = t(quats(rng, 37))
    q[0] = q[0] * 2.0
    want = [q[0]]
    for i in range(1, 37):
        want.append(tgeo.quat_normalize(tgeo.quat_multiply(want[-1], q[i])))
    got = tpose._prefix_product(q)
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [1, 2, 5, 6])
def test_uniform_filter1d_matches_reference_and_scipy(size):
    """Against the reference at every size, and against scipy at odd sizes
    (the default window is 5).  At even sizes the reference's window sits
    one row later than scipy's (its left pad is (size - 1) // 2, scipy's
    size // 2); the port reproduces the reference."""
    x = np.random.default_rng(size).normal(size=(23, 3)).astype(np.float32)
    got = tpose._uniform_filter1d(t(x), size).numpy()
    want = np.asarray(jpose._uniform_filter1d(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    scipy = uniform_filter1d(x.astype(np.float64), size, axis=0,
                             mode="nearest")
    shift = 1 - size % 2                    # the reference's row i: scipy's i+1
    np.testing.assert_allclose(got[:len(x) - shift], scipy[shift:], rtol=0,
                               atol=1e-6)


def test_transform_to_world_frame_and_properties():
    v, w, ts = velocity_inputs(30, seed=4)
    got, want = pose_pair(v, w, ts)
    wp = np.array([10.0, -4.0, 1.0], np.float32)
    we = np.array([0.05, -0.1, 1.2], np.float32)
    gw = tpose.transform_to_world_frame(got, t(wp), t(we))
    jw = jpose.transform_to_world_frame(want, jnp.asarray(wp),
                                        jnp.asarray(we))
    assert_trajectory_close(gw, jw, 30)
    np.testing.assert_allclose(gw.rotations.numpy(), np.asarray(jw.rotations),
                               rtol=0, atol=QUAT_TOL)
    assert float(gw.total_distance) == pytest.approx(
        float(jw.total_distance), rel=1e-5)
    assert float(gw.duration) == float(jw.duration)


# ---- the reference's pose scenes (tests/test_motion.py:138-192) -------------

def test_pose_integration_straight_line():
    N = 50
    ts = torch.arange(N, dtype=torch.float32) * DT
    v = torch.tensor([10.0, 0.0, 0.0]).repeat(N, 1)
    traj = tpose.integrate_pose(v, torch.zeros((N, 3)), ts, PoseConfig())
    np.testing.assert_allclose(traj.positions[-1].numpy(),
                               [10.0 * DT * (N - 1), 0, 0], atol=1e-4)
    np.testing.assert_allclose(traj.orientations.numpy(), 0.0, atol=1e-6)


def test_pose_integration_circle():
    N, v0, w0 = 200, 5.0, 0.5
    ts = torch.arange(N, dtype=torch.float32) * 0.01
    v = torch.tensor([v0, 0.0, 0.0]).repeat(N, 1)
    w = torch.tensor([0.0, 0.0, w0]).repeat(N, 1)
    traj = tpose.integrate_pose(v, w, ts, PoseConfig(),
                                rotate_velocities=True)
    radius = v0 / w0
    d = np.linalg.norm(traj.positions[:, :2].numpy()
                       - np.array([0.0, radius]), axis=1)
    np.testing.assert_allclose(d, radius, atol=0.05)
    np.testing.assert_allclose(traj.orientations[-1, 2].item(),
                               w0 * 0.01 * (N - 1), atol=1e-3)


def test_pose_reference_parity_mode_ignores_heading():
    N = 10
    ts = torch.arange(N, dtype=torch.float32) * DT
    v = torch.tensor([10.0, 0.0, 0.0]).repeat(N, 1)
    w = torch.tensor([0.0, 0.0, 1.0]).repeat(N, 1)
    traj = tpose.integrate_pose(v, w, ts, PoseConfig(),
                                rotate_velocities=False)
    assert abs(float(traj.positions[-1, 1])) < 1e-5


def test_trapezoid_vs_euler():
    N = 20
    ts = torch.arange(N, dtype=torch.float32) * DT
    v = torch.stack([ts, torch.zeros(N), torch.zeros(N)], dim=1)
    w = torch.zeros((N, 3))
    tr = tpose.integrate_pose(v, w, ts,
                              PoseConfig(integration_method="trapezoidal"))
    eu = tpose.integrate_pose(v, w, ts, PoseConfig(integration_method="euler"))
    exact = 0.5 * float(ts[-1]) ** 2
    assert abs(float(tr.positions[-1, 0]) - exact) < \
        abs(float(eu.positions[-1, 0]) - exact)
    with pytest.raises(ValueError, match="integration method"):
        tpose.integrate_pose(v, w, ts, PoseConfig(integration_method="rk4"))
