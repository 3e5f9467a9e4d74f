"""Extended Kalman filter localization on tensors.

Port of ``tpuslam/filters/ekf.py`` (reference: ``ExtendedKalmanFilter``,
extended_kalman_filter.py:17-205): circular-motion process model, GPS-like
position observation with robot-frame noise, analytic Jacobians, the
standard (non-Joseph) covariance update and the fused sim+filter step
``main_ekf`` (extended_kalman_filter.py:86-130).

Plain functions on tensors of any leading batch shape; noise comes from
an explicit ``torch.Generator``; rollouts are a Python loop over steps.
Every function runs in float32 and float64 (the dtype of the state).
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.core.se2 import robot_to_world
from tpuslam_torch.models.process import circular_jacobian, circular_step


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """Static EKF configuration; defaults = reference values.

    Field for field the JAX package's ``EkfConfig``.  Stds are stored,
    not covariances (covariance = diag(std)^2); ``q_std``'s yaw entry
    keeps the reference's degrees quirk (extended_kalman_filter.py:54).
    """

    dt: float = 0.1  # period_ms=100 (extended_kalman_filter.py:278)
    radius_m: float = 10.0  # __RADIUS_m (:32)
    yaw_rate: float = math.radians(10.0)  # __YAW_RATE_rps (:33)
    # Filter noise model (:52-60)
    q_std: tuple = (0.1, 0.1, math.radians(0.1))
    r_std: tuple = (1.0, 1.0)
    # Simulation ("actual") noise (:64-72); defaults equal the filter's.
    q_act_std: tuple = (0.1, 0.1, math.radians(0.1))
    r_act_std: tuple = (1.0, 1.0)
    # Initial state (:74-84)
    x0: tuple = (10.0, 0.0, math.pi / 2.0)
    p0_std: tuple = (0.01, 0.01, math.radians(30.0))

    @property
    def vel(self) -> float:
        """Commanded velocity = radius * yaw_rate (:34)."""
        return self.radius_m * self.yaw_rate


class EkfState(typing.NamedTuple):
    """Filter + simulation state (leading dims = batch)."""

    x_true: torch.Tensor  # (..., 3) ground truth
    x_dr: torch.Tensor  # (..., 3) dead reckoning
    x_hat: torch.Tensor  # (..., 3) posterior estimate
    cov: torch.Tensor  # (..., 3, 3) posterior covariance


class EkfOut(typing.NamedTuple):
    """Per-step outputs, mirroring main_ekf's returns (:130)."""

    x_true: torch.Tensor
    x_dr: torch.Tensor
    z: torch.Tensor  # (..., 2) observation
    x_pre: torch.Tensor  # (..., 3) prior (pre-update) estimate
    cov: torch.Tensor  # (..., 3, 3) posterior covariance


def _vec(values: tuple, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _diag_sq(std: tuple, like: torch.Tensor) -> torch.Tensor:
    s = _vec(std, like)
    return torch.diag(s * s)


def ekf_init(cfg: EkfConfig, batch_shape: tuple = (), *,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cpu") -> EkfState:
    """Initial state (extended_kalman_filter.py:74-84), broadcast to
    ``batch_shape``."""
    x0 = torch.tensor(cfg.x0, dtype=dtype, device=device)
    p0 = _diag_sq(cfg.p0_std, x0)
    x0 = x0.expand(tuple(batch_shape) + (3,))
    p0 = p0.expand(tuple(batch_shape) + (3, 3))
    return EkfState(x_true=x0, x_dr=x0, x_hat=x0, cov=p0)


@highest_matmul_precision
def ekf_predict(cfg: EkfConfig, x_hat: torch.Tensor, cov: torch.Tensor):
    """EKF prediction (extended_kalman_filter.py:109-115).

    Returns ``(x_prior, cov_prior)``.
    """
    x_pre = circular_step(x_hat, cfg.vel, cfg.yaw_rate, cfg.dt)
    f_jac = circular_jacobian(x_hat, cfg.vel, cfg.dt)
    q = _diag_sq(cfg.q_std, x_hat)
    cov_pre = torch.einsum("...ij,...jk,...lk->...il", f_jac, cov,
                           f_jac) + q
    return x_pre, cov_pre


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Analytic batched 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([
        torch.stack([d, -b], dim=-1),
        torch.stack([-c, a], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


@highest_matmul_precision
def ekf_update(cfg: EkfConfig, x_pre: torch.Tensor, cov_pre: torch.Tensor,
               z: torch.Tensor):
    """EKF measurement update (extended_kalman_filter.py:117-128).

    H = [[1,0,0],[0,1,0]]; gain G = P- H^T (H P- H^T + R)^-1; the
    posterior covariance is the standard (I - G H) P-, not Joseph.

    Returns ``(x_post, cov_post)``.
    """
    r = _diag_sq(cfg.r_std, x_pre)
    innov = z - x_pre[..., :2]
    s = cov_pre[..., :2, :2] + r
    gain = torch.einsum("...ij,...jk->...ik", cov_pre[..., :, :2],
                        _inv2x2(s))
    x_post = x_pre + torch.einsum("...ij,...j->...i", gain, innov)
    x_post = torch.cat([x_post[..., :2], wrap_angle(x_post[..., 2:])],
                       dim=-1)
    cov_post = cov_pre - torch.einsum("...ij,...jk->...ik", gain,
                                      cov_pre[..., :2, :])
    return x_post, cov_post


def ekf_step_with_noise(cfg: EkfConfig, state: EkfState,
                        obs_noise: torch.Tensor, dr_noise: torch.Tensor):
    """Fused sim+filter step with caller-supplied noise.

    Args:
        obs_noise: ``(..., 2)`` robot-frame observation noise, already
            scaled (:100).
        dr_noise: ``(..., 3)`` additive dead-reckoning noise, already
            scaled (:105).  It is added after the wrapped circular step,
            so the returned ``x_dr`` yaw is not re-wrapped.

    Returns:
        ``(next_state, EkfOut)``.
    """
    x_true = circular_step(state.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)
    z = robot_to_world(x_true, obs_noise[..., None, :])[..., 0, :]
    x_dr = circular_step(state.x_dr, cfg.vel, cfg.yaw_rate,
                         cfg.dt) + dr_noise
    x_pre, cov_pre = ekf_predict(cfg, state.x_hat, state.cov)
    x_post, cov_post = ekf_update(cfg, x_pre, cov_pre, z)
    next_state = EkfState(x_true=x_true, x_dr=x_dr, x_hat=x_post,
                          cov=cov_post)
    out = EkfOut(x_true=x_true, x_dr=x_dr, z=z, x_pre=x_pre, cov=cov_post)
    return next_state, out


def _draw_noise(cfg: EkfConfig, generator: torch.Generator, lead: tuple,
                like: torch.Tensor):
    def draw(n, std):
        return torch.randn(lead + (n,), generator=generator,
                           dtype=like.dtype,
                           device=like.device) * _vec(std, like)

    return draw(2, cfg.r_act_std), draw(3, cfg.q_act_std)


def ekf_step(cfg: EkfConfig, state: EkfState, generator: torch.Generator):
    """One fused sim+filter step (main_ekf, :86-130) with noise drawn
    from ``generator`` (on the state's device).

    Returns ``(next_state, EkfOut)``.
    """
    obs_noise, dr_noise = _draw_noise(cfg, generator,
                                      tuple(state.x_true.shape[:-1]),
                                      state.x_true)
    return ekf_step_with_noise(cfg, state, obs_noise, dr_noise)


def ekf_rollout(cfg: EkfConfig, generator: torch.Generator, n_steps: int,
                state0: EkfState | None = None):
    """Run ``n_steps`` EKF steps.

    All noise is drawn in bulk up front (as the JAX package does) and
    the steps run as a Python loop.  ``state0`` defaults to
    :func:`ekf_init` in float32 on the generator's device.

    Returns:
        ``(final_state, outs)``; each field of ``outs`` is stacked along
        a leading time axis.
    """
    if state0 is None:
        state0 = ekf_init(cfg, device=generator.device)
    lead = (n_steps,) + tuple(state0.x_true.shape[:-1])
    obs_noise, dr_noise = _draw_noise(cfg, generator, lead, state0.x_true)
    state = state0
    outs = []
    for i in range(n_steps):
        state, out = ekf_step_with_noise(cfg, state, obs_noise[i],
                                         dr_noise[i])
        outs.append(out)
    return state, EkfOut(*(torch.stack(f) for f in zip(*outs)))


def ekf_rollout_batch(cfg: EkfConfig, generator: torch.Generator,
                      batch: int, n_steps: int, *,
                      dtype: torch.dtype = torch.float32):
    """Monte-Carlo sweep of ``batch`` independent rollouts on the
    generator's device (BASELINE config 3 is 8192 rollouts).

    Returns:
        ``(final_state, outs)`` in the JAX package's layout: the final
        state is ``(batch, ...)`` and every field of ``outs`` is
        ``(batch, n_steps, ...)``.
    """
    state0 = ekf_init(cfg, (batch,), dtype=dtype, device=generator.device)
    final, outs = ekf_rollout(cfg, generator, n_steps, state0)
    return final, EkfOut(*(f.movedim(0, 1) for f in outs))
