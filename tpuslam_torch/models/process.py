"""Circular-motion process model shared by the EKF and PF.

Port of ``tpuslam/models/process.py`` (reference: the ``__f`` state
equation and ``__jacobF``, extended_kalman_filter.py:160-194): the
unicycle Euler step x += v dt cos(yaw); y += v dt sin(yaw);
yaw += w dt (wrapped), on ``(..., 3)`` pose tensors.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.angles import wrap_angle


def circular_step(pose: torch.Tensor, v: float, w: float,
                  dt: float) -> torch.Tensor:
    """Propagate ``(..., 3)`` poses one step; yaw is wrapped."""
    yaw = pose[..., 2]
    return torch.stack([
        pose[..., 0] + v * dt * torch.cos(yaw),
        pose[..., 1] + v * dt * torch.sin(yaw),
        wrap_angle(yaw + w * dt),
    ], dim=-1)


def circular_jacobian(pose: torch.Tensor, v: float,
                      dt: float) -> torch.Tensor:
    """Analytic ``(..., 3, 3)`` Jacobian dF/dx of :func:`circular_step`:
    ``[[1, 0, -dt v sin(yaw)], [0, 1, dt v cos(yaw)], [0, 0, 1]]``."""
    yaw = pose[..., 2]
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    a = -dt * v * torch.sin(yaw)
    b = dt * v * torch.cos(yaw)
    return torch.stack([
        torch.stack([o, z, a], dim=-1),
        torch.stack([z, o, b], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
