"""SE(2) world<->robot coordinate transforms on tensors.

Port of ``tpuslam/core/se2.py`` (reference: mylib/transform.py:12-59,
``BASE_ANG = pi/2``: the robot's forward axis is world +y at yaw pi/2).
Poses are ``(..., 3)`` rows ``[x, y, yaw]``; points are ``(..., N, 2)``;
leading batch dimensions broadcast.
"""

from __future__ import annotations

import math

import torch

#: Heading convention offset: robot forward = world +y at yaw = BASE_ANG.
BASE_ANG = math.pi / 2.0


def world_to_robot(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """World-frame points ``(..., N, 2)`` into the frame of ``pose``."""
    yaw = BASE_ANG - pose[..., 2]
    c = torch.cos(yaw)[..., None]
    s = torch.sin(yaw)[..., None]
    d = points - pose[..., None, :2]
    dx, dy = d[..., 0], d[..., 1]
    return torch.stack([c * dx - s * dy, s * dx + c * dy], dim=-1)


def robot_to_world(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Robot-frame points ``(..., N, 2)`` into the world frame; the
    exact inverse of :func:`world_to_robot`."""
    yaw = pose[..., 2] - BASE_ANG
    c = torch.cos(yaw)[..., None]
    s = torch.sin(yaw)[..., None]
    px, py = points[..., 0], points[..., 1]
    rx = c * px - s * py
    ry = s * px + c * py
    return torch.stack([rx, ry], dim=-1) + pose[..., None, :2]
