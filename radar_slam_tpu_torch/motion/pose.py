"""Velocity-to-pose integration: quaternion orientation, dead-reckoned
positions, and the planar update of the sequential drivers.

Counterpart of ``radar_slam_tpu/motion/pose.py``.  The reference composes
the per-frame SO(3) increments in a ``lax.scan`` of quaternion products,
normalizing after every step; here they compose in a log-depth
(Hillis-Steele) prefix product, normalizing after every combine
(:func:`_prefix_product`), so a sequence of N frames costs about
ceil(log2 N) rounds of elementwise launches instead of N.  The quaternion
product is associative, so both orders give the same rotations up to
float32 rounding.  Positions are a float32 cumulative sum, as in the
reference; its summation order differs between devices.

``rotate_velocities=True`` (the default) rotates each body-frame velocity by
the current orientation before integrating (dead reckoning);
``False`` integrates the body velocities as if they were world-frame, as
the reference's pose integrator does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from radar_slam_tpu_torch.core import geometry as geo
from radar_slam_tpu_torch.core.config import PoseConfig
from radar_slam_tpu_torch.core.types import Trajectory


def _uniform_filter1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """``scipy.ndimage.uniform_filter1d(mode='nearest')`` along axis 0 of
    x [N, C]: the edge-padded moving mean of ``size`` rows."""
    if size <= 1:
        return x
    left = (size - 1) // 2
    right = size - 1 - left
    pad = torch.cat([x[:1].expand(left, -1), x,
                     x[-1:].expand(right, -1)], dim=0)
    kernel = torch.full((1, 1, size), 1.0 / size, dtype=x.dtype,
                        device=x.device)
    return F.conv1d(pad.transpose(0, 1)[:, None], kernel)[:, 0].transpose(0, 1)


def _prefix_product(q: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products q[0] * q[1] * ... * q[i] of quaternions
    [N, 4], each combine normalized; row 0 is returned as given."""
    n = q.shape[0]
    shift = 1
    while shift < n:
        q = torch.cat([q[:shift], geo.quat_normalize(
            geo.quat_multiply(q[:-shift], q[shift:]))], dim=0)
        shift *= 2
    return q


def integrate_pose(velocities: torch.Tensor, angular_velocities: torch.Tensor,
                   timestamps: torch.Tensor, cfg: PoseConfig,
                   initial_position: Optional[torch.Tensor] = None,
                   initial_orientation: Optional[torch.Tensor] = None,
                   rotate_velocities: bool = True) -> Trajectory:
    """Integrate per-frame body velocities into a trajectory.

    Args:
        velocities: [N, 3] body-frame (vx, vy, vz) per frame.
        angular_velocities: [N, 3] (wx, wy, wz) per frame.
        timestamps: [N] seconds.
        initial_position / initial_orientation: [3] position and Euler-xyz
            orientation of the first pose (zeros when None).

    Returns:
        :class:`Trajectory` with positions, Euler orientations and
        quaternions, on the device of ``velocities``.
    """
    dev = velocities.device
    n = velocities.shape[0]
    p0 = (initial_position if initial_position is not None
          else torch.zeros(3, device=dev)).to(dev, torch.float32)
    e0 = (initial_orientation if initial_orientation is not None
          else torch.zeros(3, device=dev)).to(dev, torch.float32)
    q0 = geo.quat_from_euler_xyz(e0)

    dts = torch.diff(timestamps).to(torch.float32)                # [N-1]
    # q_i = q_{i-1} * dq(w_{i-1} dt_{i-1}), composed as a prefix product.
    dq = geo.quat_from_axis_angle(angular_velocities[:-1] * dts[:, None])
    quats = _prefix_product(torch.cat([q0[None], dq], dim=0))      # [N, 4]

    v_world = (geo.quat_rotate(quats, velocities) if rotate_velocities
               else velocities)
    if cfg.integration_method == "trapezoidal":
        steps = 0.5 * dts[:, None] * (v_world[:-1] + v_world[1:])
    elif cfg.integration_method == "euler":
        steps = dts[:, None] * v_world[:-1]
    else:
        raise ValueError(
            f"Unknown integration method: {cfg.integration_method}")
    positions = p0[None] + torch.cat(
        [torch.zeros((1, 3), device=dev), torch.cumsum(steps, dim=0)], dim=0)

    if cfg.smoothing and n > cfg.smoothing_window:
        positions = _uniform_filter1d(positions, cfg.smoothing_window)

    return Trajectory(
        timestamps=timestamps,
        positions=positions,
        orientations=geo.quat_to_euler_xyz(quats),
        quaternions=quats,
        velocities=velocities,
        angular_velocities=angular_velocities,
    )


def transform_to_world_frame(traj: Trajectory, world_position: torch.Tensor,
                             world_orientation_euler: torch.Tensor
                             ) -> Trajectory:
    """Rigidly move a body-frame trajectory into a world frame given by a
    position [3] and Euler-xyz orientation [3]."""
    dev = traj.positions.device
    q_w = geo.quat_from_euler_xyz(
        torch.as_tensor(world_orientation_euler, device=dev).to(torch.float32))
    q_w = q_w.expand(traj.quaternions.shape)
    wp = torch.as_tensor(world_position, device=dev).to(traj.positions.dtype)
    new_pos = wp[None, :] + geo.quat_rotate(q_w, traj.positions)
    new_q = geo.quat_multiply(q_w, traj.quaternions)
    return traj._replace(positions=new_pos, quaternions=new_q,
                         orientations=geo.quat_to_euler_xyz(new_q))


def planar_pose_step(pose_xyyaw: torch.Tensor, velocity: torch.Tensor,
                     yaw_rate: torch.Tensor, dt: float,
                     rotate: bool = True) -> torch.Tensor:
    """One planar update of poses [..., 3] (x, y, yaw) by body velocities
    [..., 3] and yaw rates [...] over ``dt``.  ``rotate`` turns the body
    velocity by the current yaw (dead reckoning); without it the update is
    ``x += vx dt; y += vy dt; yaw += wz dt``."""
    x, y, yaw = pose_xyyaw[..., 0], pose_xyyaw[..., 1], pose_xyyaw[..., 2]
    vx, vy = velocity[..., 0], velocity[..., 1]
    if rotate:
        c, s = torch.cos(yaw), torch.sin(yaw)
        vx, vy = c * vx - s * vy, s * vx + c * vy
    return torch.stack([x + vx * dt, y + vy * dt, yaw + yaw_rate * dt],
                       dim=-1)
