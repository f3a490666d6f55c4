"""Planar dead reckoning of the sequential drivers.

Counterpart of ``radar_slam_tpu/motion/pose.py:planar_pose_step``.  The
quaternion integration (``integrate_pose``) and
``transform_to_world_frame`` are not ported yet.
"""

from __future__ import annotations

import torch


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
