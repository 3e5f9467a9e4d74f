"""Particle filter localization on tensors.

Port of ``tpuslam/filters/pf.py`` (reference: ``ParticleFilter``,
particle_filter.py:18-237): the circular process model, five fixed
landmarks observed in the robot frame, the likelihood as a product over
landmarks of a bivariate normal pdf of the robot-frame discrepancy,
ESS-gated systematic (low-variance) resampling, and the
maximum-a-posteriori particle as the estimate.

Plain functions on tensors with any leading batch shape: particles are
``(..., NP, 3)``, weights ``(..., NP)``.  Noise comes from an explicit
``torch.Generator``; rollouts are a Python loop over steps.  Where the
JAX package ``vmap``s over filters, the port keeps an explicit batch
dimension, and the per-filter ESS gate becomes a mask: a step resamples
the filters whose gate fired and keeps the others, as the ``vmap``ped
``lax.cond`` (a select) does.

The interval resample (``hist``) follows the JAX package's exact-integer
law (:func:`quantize_weights_law`, :func:`boundary_law`): the same f32
weights and comb offset select the same particles bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from tpuslam_torch.core.se2 import world_to_robot
from tpuslam_torch.models.process import circular_step

#: Reference landmark table (particle_filter.py:39-43).
REF_LANDMARKS = ((5.0, 5.0), (2.0, -3.0), (-3.0, 4.0), (-5.0, -1.0),
                 (0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class PfConfig:
    """Static PF configuration; defaults = reference values.

    Field for field the JAX package's ``PfConfig``.
    ``ess_threshold_frac`` expresses the reference's gate ``ESS < NP/100``
    (particle_filter.py:33,211) as a fraction of NP.
    """

    dt: float = 0.1  # period_ms=100 (particle_filter.py:333)
    num_particles: int = 1000  # __NP (:31)
    radius_m: float = 10.0  # (:46)
    yaw_rate: float = math.radians(10.0)  # (:47)
    landmarks: tuple = REF_LANDMARKS
    # System noise stds (:62-65); yaw std given in degrees in the reference.
    q_std: tuple = (0.03, 0.03, math.radians(2.0))
    # Observation noise stds (:68-70).
    r_std: tuple = (0.3, 0.3)
    ess_threshold_frac: float = 1.0 / 100.0  # (:33)
    x0: tuple = (10.0, 0.0, math.pi / 2.0)  # (:74-79)
    #: "map" = argmax-weight particle (reference, :115-117); "mean" =
    #: weighted mean with circular yaw averaging.
    estimate: str = "map"
    #: "linear" = the reference's raw pdf products (can underflow to the
    #: NaN reset); "log" = log-space weights with logsumexp normalization.
    weight_mode: str = "linear"
    #: "search" = searchsorted comb (reference-exact selection); "hist" =
    #: the exact-integer interval decode; "merge" = hist selection through
    #: the resample kernels on the fused path (ops/resample_cuda.py); the
    #: plain paths treat it as "hist".
    resample_method: str = "search"

    @property
    def vel(self) -> float:
        return self.radius_m * self.yaw_rate


class PfState(typing.NamedTuple):
    x_true: torch.Tensor  # (..., 3)
    particles: torch.Tensor  # (..., NP, 3)
    weights: torch.Tensor  # (..., NP) normalized


class PfOut(typing.NamedTuple):
    x_true: torch.Tensor
    x_est: torch.Tensor  # (..., 3)
    particles: torch.Tensor
    weights: torch.Tensor
    max_idx: torch.Tensor  # argmax-weight index (the reference returns it)
    max_w: torch.Tensor
    ess: torch.Tensor  # effective sample size before resampling
    resampled: torch.Tensor  # bool


def pf_init(cfg: PfConfig, batch_shape: tuple = (), *,
            dtype: torch.dtype = torch.float32,
            device: torch.device | str) -> PfState:
    """All particles at x0 with uniform weights (particle_filter.py:77-84),
    broadcast to ``batch_shape``; made without a host sync on a CUDA
    device."""
    # ops imports this module, so the helper is imported at call time.
    from tpuslam_torch.ops._build import device_constant

    lead = tuple(batch_shape)
    x0 = device_constant(cfg.x0, torch.empty(0, dtype=dtype, device=device))
    return PfState(
        x_true=x0.expand(lead + (3,)),
        particles=x0.expand(lead + (cfg.num_particles, 3)),
        weights=torch.full(lead + (cfg.num_particles,),
                           1.0 / cfg.num_particles, dtype=dtype,
                           device=device))


def bivariate_normal_pdf(dx, dy, sigma_x, sigma_y, sigma_xy=0.0):
    """Closed-form bivariate normal pdf (the removed
    ``matplotlib.mlab.bivariate_normal`` of particle_filter.py:191, with
    the means folded into ``dx``, ``dy``); ``sigma_xy`` is the
    covariance."""
    rho = sigma_xy / (sigma_x * sigma_y)
    one_m_rho2 = 1.0 - rho * rho
    zx = dx / sigma_x
    zy = dy / sigma_y
    expo = (zx * zx + zy * zy - 2.0 * rho * zx * zy) / (2.0 * one_m_rho2)
    root = torch.sqrt(torch.as_tensor(one_m_rho2, dtype=dx.dtype,
                                      device=dx.device))
    norm = 2.0 * math.pi * sigma_x * sigma_y * root
    return torch.exp(-expo) / norm


def quantize_weights_law(weights: torch.Tensor,
                         total: torch.Tensor) -> torch.Tensor:
    """The interval-resample quantization: integers of ``2^-20 * total``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.  Every
    interval decode (:func:`quantized_cum`, the resample kernels'
    shared prerequisites) quantizes with this expression.
    """
    return torch.round(weights * (float(1 << 20) / total))


def quantized_cum(weights: torch.Tensor):
    """Exact-integer weight cumsum for interval-based selection.

    Integer partial sums below ``2^24`` are exact in f32 in any order, so
    the cumsum is non-decreasing and order-independent.  Returns
    ``(cum, total)`` in the input dtype, ``total`` with a trailing axis
    of 1.
    """
    total_w = weights.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(quantize_weights_law(weights, total_w), dim=-1)
    return cum, cum[..., -1:]


def boundary_law(cum, inv_tot, n, offs):
    """The slot-boundary law ``t = ceil(n * (cum * inv_tot) - offs)``.

    Multiplies and one subtract, no division; each eager torch op rounds
    once (no FMA contraction), as the resample kernel's ``__fmul_rn`` /
    ``__fsub_rn`` do.  ``cum`` is the exact-integer quantized cumsum and
    ``inv_tot`` the reciprocal of its total, computed once.
    """
    return torch.ceil(n * (cum * inv_tot) - offs)


def resample_indices(generator: torch.Generator, weights: torch.Tensor,
                     method: str = "search") -> torch.Tensor:
    """Systematic-resampling index selection with the comb offset drawn
    from ``generator`` (one per filter); returns ``(..., N)`` indices."""
    offs = torch.rand(weights.shape[:-1], generator=generator,
                      dtype=weights.dtype, device=weights.device)
    return resample_indices_from_offs(offs, weights, method)


def resample_indices_from_offs(offs, weights: torch.Tensor,
                               method: str = "search") -> torch.Tensor:
    """Index selection from a caller-supplied comb offset.

    ``offs`` (uniform in [0, 1), in units of ``1/N``: the reference's
    ``np.random.rand()`` at particle_filter.py:214) is a scalar or has
    the weights' leading shape.

    ``hist`` is the last-occurrence scatter plus a running maximum
    (``torch.cummax``) over the exact-integer slot boundaries; ``search``
    is ``torch.searchsorted(side="left")`` on the raw cumsum.
    """
    n = weights.shape[-1]
    offs = torch.as_tensor(offs, dtype=weights.dtype,
                           device=weights.device)[..., None]
    if method == "merge":  # kernel method; identical selection to "hist"
        method = "hist"
    if method == "hist":
        cumq, q_tot = quantized_cum(weights)
        t = boundary_law(cumq, 1.0 / q_tot, n, offs).to(torch.int64)
        return decode_slots(t.clamp(0, n))
    cum = torch.cumsum(weights, dim=-1)
    u = (torch.arange(n, dtype=weights.dtype, device=weights.device)
         + offs) / n
    idx = torch.searchsorted(cum.contiguous(),
                             u.expand(cum.shape).contiguous(), side="left")
    return idx.clamp(0, n - 1)


def decode_slots(t: torch.Tensor) -> torch.Tensor:
    """Gather indices from ``(..., N)`` int64 slot boundaries in
    ``[0, N]``: ``idx[i] = j`` with ``t[j-1] <= i < t[j]``, clamped to
    ``[0, N-1]``.

    ``idx[i] = #{j : t_j <= i}``: the last lane of each run of equal
    ``t`` writes 1 + its index at slot ``t``; a running maximum
    (``torch.cummax``) fills forward.
    """
    n = t.shape[-1]
    last = torch.ones_like(t, dtype=torch.bool)
    last[..., :-1] = t[..., :-1] != t[..., 1:]
    tgt = torch.where(last, t, n)
    src = torch.arange(1, n + 1, device=t.device).expand_as(tgt)
    sparse = torch.zeros(t.shape[:-1] + (n + 1,), dtype=torch.int64,
                         device=t.device)
    sparse.scatter_(-1, tgt, src)  # only dropped lanes share slot n
    return torch.cummax(sparse[..., :n], dim=-1).values.clamp(0, n - 1)


def systematic_resample(generator: torch.Generator, particles: torch.Tensor,
                        weights: torch.Tensor, method: str = "search"):
    """Low-variance systematic resampling; selection identical to the
    reference's comb walk (particle_filter.py:212-221).

    Returns ``(particles_resampled, uniform_weights)``.
    """
    n = weights.shape[-1]
    idx = resample_indices(generator, weights, method)
    return (torch.take_along_dim(particles, idx[..., None], dim=-2),
            torch.full_like(weights, 1.0 / n))


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / sum(w^2) (particle_filter.py:210)."""
    return 1.0 / torch.sum(weights * weights, dim=-1)


def pf_likelihood(cfg: PfConfig, particles: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Per-particle likelihood of the landmark observation
    (particle_filter.py:170-198).

    Args:
        particles: ``(..., NP, 3)``.
        z: ``(..., L, 2)`` observed robot-frame landmarks, one set per
            filter.

    Returns:
        ``(..., NP)`` likelihoods (linear mode) or log-likelihoods (log
        mode).
    """
    lm = torch.tensor(cfg.landmarks, dtype=particles.dtype,
                      device=particles.device)
    sx, sy = cfg.r_std
    d = world_to_robot(particles, lm) - z[..., None, :, :]
    if cfg.weight_mode == "log":
        zx = d[..., 0] / sx
        zy = d[..., 1] / sy
        log_norm = torch.log(torch.tensor(2.0 * math.pi * sx * sy,
                                          dtype=particles.dtype,
                                          device=particles.device))
        log_pdf = -0.5 * (zx * zx + zy * zy) - log_norm
        return log_pdf.sum(dim=-1)
    return bivariate_normal_pdf(d[..., 0], d[..., 1], sx, sy).prod(dim=-1)


def _normalize(cfg: PfConfig, w: torch.Tensor) -> torch.Tensor:
    """Normalize with the NaN->uniform reset (particle_filter.py:226-237)."""
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.where(torch.isnan(w), 1.0 / cfg.num_particles, w)


def weights_from_log(cfg: PfConfig, log_w: torch.Tensor,
                     lse: torch.Tensor) -> torch.Tensor:
    """Normalized weights from unnormalized log weights and their
    logsumexp, with the NaN->uniform reset of particle_filter.py:226-237:
    the one home of the reset predicate for every log-weight path."""
    lw_n = log_w - lse
    bad = torch.isnan(lw_n) | ~torch.isfinite(lse)
    return torch.where(bad, 1.0 / cfg.num_particles, torch.exp(lw_n))


def pf_estimate(cfg: PfConfig, particles: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Point estimate: the argmax-weight particle (``map``, the
    reference's estimator, :115-117; the first on a tie) or the weighted
    mean with circular yaw averaging (``mean``)."""
    if cfg.estimate == "mean":
        xy = torch.einsum("...n,...ni->...i", weights, particles[..., :2])
        yaw = particles[..., 2]
        cs = torch.einsum("...n,...n->...", weights, torch.cos(yaw))
        sn = torch.einsum("...n,...n->...", weights, torch.sin(yaw))
        return torch.cat([xy, torch.atan2(sn, cs)[..., None]], dim=-1)
    idx = torch.argmax(weights, dim=-1)
    return torch.take_along_dim(particles, idx[..., None, None],
                                dim=-2)[..., 0, :]


def pf_step_with_noise(cfg: PfConfig, state: PfState, resample_offs,
                       pred_noise: torch.Tensor, obs_noise: torch.Tensor):
    """One fused sim+filter step with caller-supplied noise.

    Args:
        resample_offs: comb offset in [0, 1) (units of ``1/NP``), a
            scalar or one per filter; consumed only where the gate fires.
        pred_noise: ``(..., NP, 3)`` additive system noise, already
            scaled (particle_filter.py:165).
        obs_noise: ``(..., L, 2)`` additive robot-frame observation
            noise, already scaled (particle_filter.py:152).

    Returns:
        ``(next_state, PfOut)``.
    """
    x_true = circular_step(state.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)

    # ESS-gated systematic resampling of the filters whose gate fired
    # (:104, 200-224); one host sync decides whether any did.
    ess = effective_sample_size(state.weights)
    resampled = ess < cfg.num_particles * cfg.ess_threshold_frac
    particles, weights = state.particles, state.weights
    if bool(resampled.any()):
        idx = resample_indices_from_offs(resample_offs, weights,
                                         cfg.resample_method)
        fired = resampled[..., None]
        particles = torch.where(
            fired[..., None],
            torch.take_along_dim(particles, idx[..., None], dim=-2),
            particles)
        weights = torch.where(fired, 1.0 / cfg.num_particles, weights)

    particles = circular_step(particles, cfg.vel, cfg.yaw_rate,
                              cfg.dt) + pred_noise
    lm = torch.tensor(cfg.landmarks, dtype=x_true.dtype,
                      device=x_true.device)
    z = world_to_robot(x_true, lm) + obs_noise

    like = pf_likelihood(cfg, particles, z)
    if cfg.weight_mode == "log":
        lw = torch.log(weights) + like
        lse = torch.logsumexp(lw, dim=-1, keepdim=True)
        weights = weights_from_log(cfg, lw, lse)
    else:
        weights = _normalize(cfg, weights * like)

    x_est = pf_estimate(cfg, particles, weights)
    next_state = PfState(x_true=x_true, particles=particles, weights=weights)
    out = PfOut(x_true=x_true, x_est=x_est, particles=particles,
                weights=weights, max_idx=torch.argmax(weights, dim=-1),
                max_w=weights.amax(dim=-1), ess=ess, resampled=resampled)
    return next_state, out


def pf_step(cfg: PfConfig, state: PfState, generator: torch.Generator):
    """One fused sim+filter step (main_pf, particle_filter.py:86-119) with
    the comb offset and noise drawn from ``generator`` (on the state's
    device)."""
    like = state.particles
    lead = tuple(state.x_true.shape[:-1])
    f = dict(generator=generator, dtype=like.dtype, device=like.device)
    offs = torch.rand(lead, **f)
    pred_noise = torch.randn(like.shape, **f) * torch.tensor(
        cfg.q_std, dtype=like.dtype, device=like.device)
    obs_noise = torch.randn(lead + (len(cfg.landmarks), 2), **f) * \
        torch.tensor(cfg.r_std, dtype=like.dtype, device=like.device)
    return pf_step_with_noise(cfg, state, offs, pred_noise, obs_noise)


def check_generator(generator: torch.Generator,
                    device: torch.device | str) -> torch.device:
    """``device`` as a :class:`torch.device`; raises unless ``generator``
    lies on it (a rollout never draws on one device and runs on another)."""
    device = torch.device(device)
    if generator.device.type != device.type or (
            device.index is not None
            and generator.device.index != device.index):
        raise ValueError(f"generator on {generator.device}, rollout on "
                         f"{device}: make the generator on the rollout's "
                         "device")
    return device


def pf_rollout(cfg: PfConfig, generator: torch.Generator, n_steps: int,
               state0: PfState | None = None, keep_particles: bool = False,
               *, device: torch.device | str):
    """Run ``n_steps`` PF steps on ``device``.

    ``device`` is required, and ``generator`` must lie on it.  ``state0``
    defaults to :func:`pf_init` there.  By default each step's particle
    cloud and weights are dropped from the stacked outputs (their fields
    are empty), so a large rollout does not keep ``n_steps`` clouds;
    pass ``keep_particles=True`` to keep them.

    Returns:
        ``(final_state, outs)``; each field of ``outs`` is stacked along
        a leading time axis.
    """
    device = check_generator(generator, device)
    if state0 is None:
        state0 = pf_init(cfg, device=device)
    state = state0
    outs = []
    for _ in range(n_steps):
        state, out = pf_step(cfg, state, generator)
        if not keep_particles:
            empty = state.weights.new_zeros((0,))
            out = out._replace(particles=empty, weights=empty)
        outs.append(out)
    return state, PfOut(*(torch.stack(f) for f in zip(*outs)))


def pf_rollout_batch(cfg: PfConfig, generator: torch.Generator, batch: int,
                     n_steps: int, *, device: torch.device | str):
    """``batch`` independent PF rollouts advanced in lockstep on
    ``device`` (required; ``generator`` must lie on it): the Monte-Carlo
    sweep of many small filters.

    Every step computes the resample of all filters when any gate fires
    and keeps it only for those that fired, as the JAX package's
    ``vmap`` does.

    Returns:
        ``(final_state, outs)`` with a leading ``batch`` axis; every
        field of ``outs`` is ``(batch, n_steps, ...)`` (the dropped
        particle and weight fields are ``(batch, n_steps, 0)``).
    """
    device = check_generator(generator, device)
    state0 = pf_init(cfg, (batch,), device=device)
    final, outs = pf_rollout(cfg, generator, n_steps, state0, device=device)
    empty = outs.weights.new_zeros((batch, n_steps, 0))
    outs = PfOut(*(torch.movedim(f, 0, 1) for f in outs))
    return final, outs._replace(particles=empty, weights=empty)
