"""Geometry primitives: angle wrapping, ULA and URA steering vectors,
line-of-sight directions, and the SO(3) helpers (quaternions, rotation
matrices, Euler angles) of the pose integration.

Counterpart of ``radar_slam_tpu/core/geometry.py`` (same conventions: the
ULA element n sits at n * spacing, steering phase 2 pi n d sin(az) /
lambda; the URA is flattened row-major [el, az]).  Every function is float32 in, float32 / complex64 out, with the
reference's operation order so results agree to float rounding.
"""

from __future__ import annotations

import math

import torch

from radar_slam_tpu_torch.core.device import DEFAULT, resolve


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def antenna_positions(num_antennas: int, spacing: float,
                      device=DEFAULT) -> torch.Tensor:
    """ULA element positions [A]."""
    return torch.arange(num_antennas, dtype=torch.float32,
                        device=resolve(device)) * spacing


def steering_vector(azimuth_rad: torch.Tensor, num_antennas: int,
                    spacing: float, lambda_c: float) -> torch.Tensor:
    """a_n(az) = exp(j 2 pi n d sin(az) / lambda): complex64 [..., A]."""
    az = torch.as_tensor(azimuth_rad, dtype=torch.float32)
    pos = antenna_positions(num_antennas, spacing, az.device)       # [A]
    phase = (2.0 * math.pi / lambda_c) * torch.sin(az)[..., None] * pos
    return torch.polar(torch.ones_like(phase), phase)


def steering_matrix(grid_rad: torch.Tensor, num_antennas: int,
                    spacing: float, lambda_c: float) -> torch.Tensor:
    """Steering matrix over an angle grid: [G, A] complex64."""
    return steering_vector(grid_rad, num_antennas, spacing, lambda_c)


def ura_steering_vector(azimuth_rad: torch.Tensor,
                        elevation_rad: torch.Tensor, num_az: int,
                        num_el: int, spacing_az: float, spacing_el: float,
                        lambda_c: float) -> torch.Tensor:
    """Steering vector(s) of a planar array, flattened row-major [el, az]:
    element (m, n) sees phase 2 pi (n d_az u_y + m d_el u_z) / lambda with
    u_y = cos el sin az, u_z = sin el.  complex64 [..., num_el * num_az];
    for num_el = 1 the ULA's :func:`steering_vector` exactly."""
    az = torch.as_tensor(azimuth_rad, dtype=torch.float32)
    el = torch.as_tensor(elevation_rad, dtype=torch.float32)
    u_y = torch.cos(el) * torch.sin(az)
    u_z = torch.sin(el)
    pos_az = antenna_positions(num_az, spacing_az, az.device)        # [Naz]
    pos_el = antenna_positions(num_el, spacing_el, az.device)        # [Nel]
    phase = (2.0 * math.pi / lambda_c) * (
        u_y[..., None, None] * pos_az[None, :]
        + u_z[..., None, None] * pos_el[:, None])                # [..., Nel, Naz]
    phase = phase.reshape(*phase.shape[:-2], num_el * num_az)
    return torch.polar(torch.ones_like(phase), phase)


def direction_vector(azimuth_rad: torch.Tensor,
                     elevation_rad: torch.Tensor) -> torch.Tensor:
    """Unit line-of-sight direction(s) [..., 3]:
    [cos el cos az, cos el sin az, sin el]."""
    az = torch.as_tensor(azimuth_rad, dtype=torch.float32)
    el = torch.as_tensor(elevation_rad, dtype=torch.float32)
    return torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az),
                        torch.sin(el)], dim=-1)


def polar_to_cartesian(range_m: torch.Tensor, azimuth_rad: torch.Tensor,
                       elevation_rad=0.0) -> torch.Tensor:
    """Target position(s) [..., 3] from polar detection coordinates."""
    r = torch.as_tensor(range_m, dtype=torch.float32)
    el = torch.zeros_like(r) + elevation_rad
    return r[..., None] * direction_vector(azimuth_rad, el)


# --------------------------------------------------------------------------
# SO(3): quaternions (w, x, y, z), rotation matrices, Euler angles
# --------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=DEFAULT) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=resolve(device))


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 over broadcast leading dims."""
    w1, x1, y1, z1 = torch.unbind(q1, dim=-1)
    w2, x2, y2, z2 = torch.unbind(q2, dim=-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_from_axis_angle(rotvec: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) from rotation vector(s) [..., 3] (axis * angle),
    branch-free at zero angle: sin(angle / 2) / angle = 0.5 sinc(angle /
    (2 pi)) with ``torch.sinc`` normalized as ``jnp.sinc`` is."""
    angle = torch.linalg.vector_norm(rotvec, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = 0.5 * torch.sinc(half / math.pi)
    return torch.cat([torch.cos(half), rotvec * k], dim=-1)


def quat_to_rotvec(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation vector(s) of quaternion(s); angle in [0, pi]."""
    q = quat_normalize(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)      # the short rotation
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)
    scale = torch.where(norm > eps,
                        angle[..., None] / torch.clamp(norm, min=eps), 2.0)
    return xyz * scale


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] of quaternion(s)."""
    w, x, y, z = torch.unbind(quat_normalize(q), dim=-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) of rotation matrices [..., 3, 3] (branch-free
    Shepperd: all four candidates, the best-conditioned one selected)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    cond0 = tr > 0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(cond0[..., None], c0,
                    torch.where(cond1[..., None], c1,
                                torch.where(cond2[..., None], c2, c3)))
    return quat_normalize(q)


def quat_from_euler_xyz(euler: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) of intrinsic-xyz Euler angles [..., 3] (roll, pitch,
    yaw): R = Rx(roll) Ry(pitch) Rz(yaw), q = qx * qy * qz."""
    half = 0.5 * euler
    cr, cp, cy = (torch.cos(half[..., 0]), torch.cos(half[..., 1]),
                  torch.cos(half[..., 2]))
    sr, sp, sy = (torch.sin(half[..., 0]), torch.sin(half[..., 1]),
                  torch.sin(half[..., 2]))
    return torch.stack([
        cr * cp * cy - sr * sp * sy,
        sr * cp * cy + cr * sp * sy,
        cr * sp * cy - sr * cp * sy,
        cr * cp * sy + sr * sp * cy,
    ], dim=-1)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Intrinsic-xyz (roll, pitch, yaw) of quaternion(s), as scipy's
    ``Rotation.as_euler('xyz')``."""
    R = quat_to_matrix(q)
    pitch = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    roll = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    yaw = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vector(s) v [..., 3] rotated by quaternion(s) q [..., 4]."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_multiply(quat_multiply(q, qv), quat_conjugate(q))[..., 1:]
