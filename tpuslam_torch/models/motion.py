"""Velocity motion model (Probabilistic Robotics ch. 5) on tensors.

Port of ``tpuslam/models/motion.py`` (reference: ``motion_model.py:14-86``,
``moveWithNoise`` / ``moveWithoutNoise``): exact circular-arc integration
of a unicycle under commanded (v, w), with six noise parameters a1..a6.

Reference quirks, each behind a config flag (default = reproduce):
  * ``sigma_squared_std`` - the reference passes the squared sigma as the
    std-dev (motion_model.py:46-48), so the effective std is sigma**2.
  * ``omega_guard`` - the reference divides by omega unguarded
    (motion_model.py:50,73); with the guard the w -> 0 limit is the
    straight line, the same for every w != 0.

Poses are ``(..., 3)``; noise comes from an explicit ``torch.Generator``
(:func:`motion_sample`) or from the caller
(:func:`motion_sample_with_noise`).
"""

from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.core.angles import wrap_angle


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Static motion-model configuration; field for field the JAX
    package's ``MotionConfig``.  Each sigma is
    ``a_odd * v^2 + a_even * w^2`` (motion_model.py:43-45)."""

    dt: float
    a1: float = 0.1
    a2: float = 0.1
    a3: float = 0.1
    a4: float = 0.1
    a5: float = 0.1
    a6: float = 0.1
    sigma_squared_std: bool = True
    omega_guard: bool = True
    omega_eps: float = 1e-7


def noise_sigmas(cfg: MotionConfig, v, w):
    """Per-command noise scales ``(sigma_v, sigma_w, sigma_gamma)``,
    squared when ``cfg.sigma_squared_std`` (motion_model.py:43-48)."""
    v2 = v * v
    w2 = w * w
    sv = cfg.a1 * v2 + cfg.a2 * w2
    sw = cfg.a3 * v2 + cfg.a4 * w2
    sg = cfg.a5 * v2 + cfg.a6 * w2
    if cfg.sigma_squared_std:
        sv, sw, sg = sv * sv, sw * sw, sg * sg
    return sv, sw, sg


def _arc_step(pose, v, w, dt, guard: bool, eps: float):
    """Exact circular-arc displacement ``(dx, dy)`` (motion_model.py:50-56,
    :73-80).  With ``guard`` the division is by a ``w_safe`` and
    ``torch.where`` takes the straight line where ``|w| < eps``, so no
    branch divides by 0; without it, Python-scalar commands with
    ``w == 0`` raise ``ZeroDivisionError`` as the reference does."""
    yaw = pose[..., 2]
    b = w * dt
    sin0, cos0 = torch.sin(yaw), torch.cos(yaw)
    sin1, cos1 = torch.sin(yaw + b), torch.cos(yaw + b)
    if guard:
        w = torch.as_tensor(w, dtype=yaw.dtype, device=yaw.device)
        straight = w.abs() < eps
        w_safe = torch.where(straight, eps, w)
        a = v / w_safe
        dx_arc = a * (sin1 - sin0)
        dy_arc = a * (cos0 - cos1)
        dx = torch.where(straight, v * dt * cos0, dx_arc)
        dy = torch.where(straight, v * dt * sin0, dy_arc)
    else:
        a = v / w
        dx = a * (sin1 - sin0)
        dy = a * (cos0 - cos1)
    return dx, dy


def motion_sample_with_noise(cfg: MotionConfig, pose, v, w, unit_noise):
    """One noisy step with the caller's ``(..., 3)`` standard-normal draws
    for (v_hat, w_hat, gamma_hat), scaled by :func:`noise_sigmas`."""
    sv, sw, sg = noise_sigmas(cfg, v, w)
    v_hat = v + unit_noise[..., 0] * sv
    w_hat = w + unit_noise[..., 1] * sw
    g_hat = unit_noise[..., 2] * sg
    dx, dy = _arc_step(pose, v_hat, w_hat, cfg.dt, cfg.omega_guard,
                       cfg.omega_eps)
    yaw_new = wrap_angle(pose[..., 2] + (w_hat + g_hat) * cfg.dt)
    return torch.stack(
        [pose[..., 0] + dx, pose[..., 1] + dy, yaw_new], dim=-1)


def motion_sample(cfg: MotionConfig, generator: torch.Generator, pose, v, w):
    """One noisy motion step (motion_model.py:31-62): three normals a
    pose from ``generator``, which must lie on the pose's device."""
    from tpuslam_torch.filters.pf import check_generator

    check_generator(generator, pose.device)
    noise = torch.randn(pose.shape[:-1] + (3,), generator=generator,
                        dtype=pose.dtype, device=pose.device)
    return motion_sample_with_noise(cfg, pose, v, w, noise)


def motion_mean(cfg: MotionConfig, pose, v, w):
    """Noiseless motion step (motion_model.py:64-86); the yaw is wrapped."""
    dx, dy = _arc_step(pose, v, w, cfg.dt, cfg.omega_guard, cfg.omega_eps)
    yaw_new = wrap_angle(pose[..., 2] + w * cfg.dt)
    return torch.stack(
        [pose[..., 0] + dx, pose[..., 1] + dy, yaw_new], dim=-1)
