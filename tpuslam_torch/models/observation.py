"""Observation models for the EKF and PF.

Port of ``tpuslam/models/observation.py``.  Noise comes from an explicit
``torch.Generator`` where the JAX package takes a key; the generator's
device must match the pose tensor's.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.se2 import robot_to_world, world_to_robot


def position_observation(generator: torch.Generator, pose_true: torch.Tensor,
                         r_chol: torch.Tensor) -> torch.Tensor:
    """Noisy ``(..., 2)`` world-frame (x, y) of the true poses, with the
    noise ``r_chol @ n`` drawn in the robot frame
    (extended_kalman_filter.py:100-101,132-146)."""
    n = torch.randn(pose_true.shape[:-1] + (2,), generator=generator,
                    dtype=pose_true.dtype, device=pose_true.device)
    w = torch.einsum("ij,...j->...i", r_chol, n)
    return robot_to_world(pose_true, w[..., None, :])[..., 0, :]


def landmark_observation(generator: torch.Generator, pose_true: torch.Tensor,
                         landmarks: torch.Tensor,
                         r_chol: torch.Tensor) -> torch.Tensor:
    """Every ``(L, 2)`` landmark in the true pose's robot frame plus iid
    Gaussian noise ``r_chol @ n``: ``(..., L, 2)``
    (particle_filter.py:144-154)."""
    z = world_to_robot(pose_true, landmarks)
    n = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                    device=z.device)
    return z + torch.einsum("ij,...j->...i", r_chol, n)
