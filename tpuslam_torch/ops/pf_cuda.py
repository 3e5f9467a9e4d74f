"""The fused particle-filter step: K2 as a CUDA kernel and its plain twin,
and the fused PF path built on it.

Port of ``tpuslam/ops/pf_pallas.py``.  One launch of ``csrc/pf_step.cu``
(see that file for the design) moves every particle one step, adds the
landmark log-likelihood to its log weight and, on the stats path,
reduces the step's logsumexp, the logsumexp of twice the log weights, the
MAP particle and the point estimate in the same launch (its last block
finishes them, so no torch op combines partial rows).  The plain twins
compute the same in plain torch, with the kernel's arithmetic (the
polynomial sincos with noise on, builtin trig with noise off, the same
wrap and operation order) and, with Philox noise, the kernel's random
bits; the two differ only by rounding (the kernel's compiler contracts
``a*b + c`` into FMAs) and the order of the sums.

State: the carried particles are plain ``(3, N)`` float32 rows and the
log weights ``(N,)``; the TPU package's sublane packing and padding are
not ported.  The step functions allocate fresh outputs, so no caller's
tensor is updated in place.

Dispatch is by device: a CPU tensor runs the plain versions; a CUDA
tensor launches the kernels or raises.  The ``*_plain`` functions run
the plain versions on any device (the card's reference).

Noise: with ``noise_on`` and no ``normals``, each particle draws three
normals by Box-Muller from Philox4x32-10 keyed by the step's seed with
the counter ``(particle index, 0, 0, 0)``.  ``normals`` of shape
``(3, N)`` (x, y, yaw rows; unscaled standard normals) replaces that
stream.  The observation noise and the comb offsets come from a
``torch.Generator`` or are supplied by the caller.

ESS gate: with ``resample_method="merge"`` the gate stays on the device.
The merge's K3a computes it from the carried normalizers and writes it
(``resample_cuda.merge_resample_gated``); K3a, pass 2 and K2b read it
there, every step, and do nothing where it is off, so the loop makes no
host synchronisation.  The other methods (``search``, the default,
``hist``, ``systematic``) resample with torch ops on the host's decision:
one synchronisation a step, counted in :data:`sync_count`.

K2 takes one plan per ``(cfg, device)``; a call passes its seed's words
and the reset flag to the library's entry.

Spans (:func:`~tpuslam_torch.utils.profiling.span`, recorded only while a
profiler records): the rollout records ``tpuslam.pf.rollout`` around the
call, ``tpuslam.pf.prepare`` from its start to the step loop,
``tpuslam.pf.step`` around each step and, inside a step,
``tpuslam.pf.resample`` around the resample (the merge, or another method
on the host's gate).
"""

from __future__ import annotations

import ctypes
import math
import typing

import numpy as np
import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.core.se2 import world_to_robot
from tpuslam_torch.filters.pf import (PfConfig, PfState, pf_init,
                                      resample_indices_from_offs,
                                      weights_from_log)
from tpuslam_torch.models.process import circular_step
from tpuslam_torch.ops import _build, resample_cuda
from tpuslam_torch.ops._build import MODE_NORMALS, MODE_OFF, MODE_PHILOX
from tpuslam_torch.ops.fastmath import (normals_from_bits, philox4x32,
                                        sincos_rad)
from tpuslam_torch.utils.profiling import span

#: Host synchronisations of the ESS gate since this count was last set
#: to 0: one a step of the fused path whose resample method is not
#: ``merge`` (the merge gates on the device and makes none).
sync_count = 0

#: The per-step kernel seed of :func:`pf_fused_rollout` and of
#: ``pf_batch_cuda.pf_batch_rollout``: the JAX package's start value and
#: advance.
SEED0 = 1
SEED_STEP = 7919

#: The kernel's kStatsOut: ``[lse, lse2, x_map, y_map, yaw_map, best_lw,
#: best index, x_est, y_est, yaw_est]``.
_STATS_LEN = 10
_MAX_LANDMARKS = 8
_NEG_INF = float("-inf")


class _PfParams(ctypes.Structure):
    """Mirror of ``PfParams`` in ``csrc/pf_step.cu``."""

    _fields_ = [("n", ctypes.c_longlong), ("key0", ctypes.c_uint32),
                ("key1", ctypes.c_uint32), ("n_lm", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "flag", "vdt", "wdt", "q0", "q1", "q2", "sx", "sy", "inv_sx",
            "inv_sy", "log_norm")] + [
        ("lm", ctypes.c_float * (2 * _MAX_LANDMARKS))]


class PfFusedState(typing.NamedTuple):
    """Carried state of the fused PF path.

    Weights live as unnormalized log weights plus their normalizers
    (``lse = logsumexp(log_w)``, ``lse2 = logsumexp(2 log_w)``), so no
    step materializes normalized weights unless it resamples.
    """

    x_true: torch.Tensor  # (3,)
    particles: torch.Tensor  # (3, N) rows x, y, yaw
    log_w: torch.Tensor  # (N,) unnormalized
    lse: torch.Tensor  # scalar
    lse2: torch.Tensor  # scalar
    x_est: torch.Tensor  # (3,) the step's point estimate


def _check(cfg: PfConfig, p_rows: torch.Tensor, lw: torch.Tensor,
           z: torch.Tensor, normals: torch.Tensor | None) -> None:
    n = cfg.num_particles
    if not 1 <= n < _build.MAX_N:
        raise ValueError(f"num_particles {n} must be in [1, 2**24)")
    if not 0 <= len(cfg.landmarks) <= _MAX_LANDMARKS:
        raise ValueError(f"at most {_MAX_LANDMARKS} landmarks")
    want = {"particles": (p_rows, (3, n)), "log_w": (lw, (n,)),
            "z": (z, (len(cfg.landmarks), 2))}
    if normals is not None:
        want["normals"] = (normals, (3, n))
    for name, (t, shape) in want.items():
        _build.check_tensor(name, t, shape, torch.float32, lw.device)


def _predict_loglik(cfg: PfConfig, z: torch.Tensor, x, y, yaw, mode: int,
                    normals: torch.Tensor | None = None, seed: int = 0):
    """The kernels' per-particle math in plain torch: circular predict
    with Q noise, then the landmark log-likelihood.

    Rows are ``(N,)`` with ``z`` of shape ``(L, 2)``, or ``(B, N)`` with
    ``z`` of shape ``(B, L, 2)`` (filter b's own observation).  Philox
    normals come from the counter ``(particle, filter, 0, 0)``, filter 0
    for ``(N,)`` rows; ``normals`` unbinds into three rows of the rows'
    shape.

    Returns the rows ``(x', y', yaw', loglik)``.
    """
    if mode == MODE_PHILOX:
        idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
        filt = (torch.arange(x.shape[0], dtype=torch.int64,
                             device=x.device)[:, None] if x.ndim == 2 else 0)
        a0, a1, a2, a3 = philox4x32(idx, filt, 0, 0,
                                    *_build.seed_words(seed))
        n0, n1 = normals_from_bits(a0, a1)
        n2, _ = normals_from_bits(a2, a3)
    elif mode == MODE_NORMALS:
        n0, n1, n2 = normals.unbind()

    vdt, wdt = cfg.vel * cfg.dt, cfg.yaw_rate * cfg.dt
    q0, q1, q2 = cfg.q_std
    if mode == MODE_OFF:
        x = x + vdt * torch.cos(yaw)
        y = y + vdt * torch.sin(yaw)
        yaw = wrap_angle(yaw + wdt)
        ang = math.pi / 2.0 - yaw
        c, s = torch.cos(ang), torch.sin(ang)
    else:
        c_o, s_o = sincos_rad(yaw)
        x = x + vdt * c_o + n0 * q0
        y = y + vdt * s_o + n1 * q1
        yaw = wrap_angle(yaw + wdt) + n2 * q2
        s, c = sincos_rad(yaw)  # (cos, sin) of pi/2 - yaw = (sin, cos) yaw

    sx, sy = cfg.r_std
    log_norm = math.log(2.0 * math.pi * sx * sy)
    acc = torch.zeros_like(x)
    for li, (lm_x, lm_y) in enumerate(cfg.landmarks):
        dx = lm_x - x
        dy = lm_y - y
        ddx = (c * dx - s * dy - z[..., li, 0, None]) / sx
        ddy = (s * dx + c * dy - z[..., li, 1, None]) / sy
        acc = acc - 0.5 * (ddx * ddx + ddy * ddy) - log_norm
    return x, y, yaw, acc


def _partial_plain(p_rows: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
    """A statistics row, as a K2b block writes one, over all particles at
    once: ``(1, 8)`` for rows ``(3, N)``, ``(N,)``; ``(..., 1, 8)`` for
    ``(3, ..., N)``, ``(..., N)``."""
    key = torch.where(torch.isnan(lw), _NEG_INF, lw)
    m = key.max(dim=-1).values
    e = torch.exp(lw - torch.clamp(m, min=-1e30)[..., None])
    idx = torch.arange(lw.shape[-1], device=lw.device)
    best = torch.where(key == m[..., None], idx, -1).max(dim=-1).values
    pick = torch.take_along_dim(p_rows, best[None, ..., None], dim=-1)[..., 0]
    row = torch.cat([torch.stack([m, e.sum(dim=-1), (e * e).sum(dim=-1)],
                                 dim=-1),
                     torch.movedim(pick, 0, -1), best.to(lw.dtype)[..., None],
                     torch.zeros_like(m)[..., None]], dim=-1)
    return row[..., None, :]


def _combine_stats(parts: torch.Tensor):
    """Reduce the ``(..., G, 8)`` partial rows over ``G``.

    Returns ``(stats, best)``: ``stats`` is ``(..., 6)``
    ``[lse, lse2, x_map, y_map, yaw_map, best_lw]`` (the JAX package's
    contract) and ``best`` the MAP particle's flat index (float32): the
    highest index among the maxima.
    """
    m_g, s_g, s2_g = parts[..., 0], parts[..., 1], parts[..., 2]
    m = m_g.max(dim=-1).values
    e = torch.exp(m_g - torch.clamp(m, min=-1e30)[..., None])
    lse = m + torch.log(torch.sum(e * s_g, dim=-1))
    lse2 = 2.0 * m + torch.log(torch.sum(e * e * s2_g, dim=-1))
    pick = torch.argmax(torch.where(m_g == m[..., None], parts[..., 6], -1.0),
                        dim=-1)
    row = torch.take_along_dim(parts, pick[..., None, None], dim=-2)[..., 0, :]
    return (torch.cat([torch.stack([lse, lse2], dim=-1), row[..., 3:6],
                       m[..., None]], dim=-1), row[..., 6])


def recip32(s: float) -> float:
    """``1 / s`` in float32, correctly rounded, of the float32 divisor a
    kernel holds (not the reciprocal of the double ``s``): the ``inv`` of
    ``pf_math.cuh::div_by_const``."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        return float(np.float32(1.0) / np.float32(s))


def _constants(cfg: PfConfig) -> dict:
    """The kernel's scalar constants as Python floats, folded in double
    as the JAX kernel's weakly typed scalars are; the observation std's
    reciprocals in float32."""
    q0, q1, q2 = cfg.q_std
    sx, sy = cfg.r_std
    lm = [v for xy in cfg.landmarks for v in xy]
    lm += [0.0] * (2 * _MAX_LANDMARKS - len(lm))
    return dict(vdt=cfg.vel * cfg.dt, wdt=cfg.yaw_rate * cfg.dt, q0=q0,
                q1=q1, q2=q2, sx=sx, sy=sy, inv_sx=recip32(sx),
                inv_sy=recip32(sy),
                log_norm=math.log(2.0 * math.pi * sx * sy),
                lm=(ctypes.c_float * (2 * _MAX_LANDMARKS))(*lm))


def _plan(cfg: PfConfig, device: torch.device) -> _build.Plan:
    """K2's launch plan for ``(cfg, device)``, built at its first launch:
    the parameters from :func:`_constants`, their key and flag left 0 for
    the entry to set."""
    return _build.plan(
        ("pf_step", cfg, device), device, "tpuslam_pf_step",
        lambda: _PfParams(n=cfg.num_particles, n_lm=len(cfg.landmarks),
                          **_constants(cfg)))


def _stats_plain(p_rows: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
    """The kernel's ``(10,)`` statistics of ``(3, N)`` rows and ``(N,)``
    log weights, by :func:`_partial_plain` and :func:`_combine_stats`
    (the JAX package's partial rows and combine), then the estimate: the
    MAP particle where ``lse`` is finite, else particle 0 (all-NaN
    weights reset to uniform, whose argmax is particle 0)."""
    stats, best = _combine_stats(_partial_plain(p_rows, lw))
    x_est = torch.where(torch.isfinite(stats[0]), stats[2:5], p_rows[:, 0])
    return torch.cat([stats, best[None], x_est])


def _check_gate(gate, p_alt, p_rows, with_stats: bool) -> None:
    if gate is None:
        return
    if not with_stats or p_alt is None:
        raise ValueError("a gate needs the statistics and the rows p_alt")
    device = p_rows.device
    _build.check_tensor("gate", gate, (2,), torch.bool, device)
    _build.check_tensor("p_alt", p_alt, tuple(p_rows.shape), torch.float32,
                        device)


def pf_step_rows_plain(cfg: PfConfig, seed: int, flag: float,
                       p_rows: torch.Tensor, lw: torch.Tensor,
                       z: torch.Tensor, noise_on: bool = True,
                       normals: torch.Tensor | None = None,
                       with_stats: bool = True, *,
                       gate: torch.Tensor | None = None,
                       p_alt: torch.Tensor | None = None):
    """Plain twin of :func:`pf_step_rows`, on any device."""
    mode = _build.noise_mode(noise_on, normals)
    _check(cfg, p_rows, lw, z, normals)
    _check_gate(gate, p_alt, p_rows, with_stats)
    if gate is not None:
        p_rows = torch.where(gate[0], p_alt, p_rows)
        lw = torch.where(gate[1], 0.0, lw)
    x, y, yaw, acc = _predict_loglik(cfg, z, p_rows[0], p_rows[1], p_rows[2],
                                     mode, normals, int(seed))
    if with_stats and gate is None and flag > 0:
        lw = torch.zeros_like(lw)
    p_rows, lw = torch.stack([x, y, yaw]), lw + acc
    return p_rows, lw, _stats_plain(p_rows, lw) if with_stats else None


def pf_step_rows(cfg: PfConfig, seed: int, flag: float,
                 p_rows: torch.Tensor, lw: torch.Tensor, z: torch.Tensor,
                 noise_on: bool = True, normals: torch.Tensor | None = None,
                 with_stats: bool = True, *,
                 gate: torch.Tensor | None = None,
                 p_alt: torch.Tensor | None = None):
    """K2: one launch of the step kernel over ``(3, N)`` rows.

    ``with_stats`` is K2b (the reset ``flag`` and the statistics), else
    K2a.  A CPU tensor runs :func:`pf_step_rows_plain`.  K2b's statistics
    go through one device counter (``csrc/pf_step.cu``), so two K2b
    launches must not run at once on one device.

    ``gate`` (K2b only) takes the flags from the device in place of
    ``flag``: a ``(2,)`` bool tensor ``[take, restart]``, as the merge's
    K3a writes it (``resample_cuda.gated_boundary``); ``take`` steps the
    rows ``p_alt`` (the resampled particles) in place of ``p_rows``, and
    ``restart`` treats the incoming log weights as zeros.

    Returns:
        ``(p_rows', lw', stats)``: fresh ``(3, N)`` and ``(N,)`` tensors
        and the ``(10,)`` statistics ``[lse, lse2, x_map, y_map, yaw_map,
        best_lw, best index, x_est, y_est, yaw_est]`` (``None`` without
        stats): the logsumexp of ``lw'`` and of ``2 lw'``, the MAP
        particle (the highest index among the maxima; a NaN log weight
        never wins), its log weight and index, and the point estimate
        (the MAP particle where ``lse`` is finite, else particle 0).
    """
    device = lw.device
    if device.type == "cpu":
        return pf_step_rows_plain(cfg, seed, flag, p_rows, lw, z, noise_on,
                                  normals, with_stats, gate=gate,
                                  p_alt=p_alt)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    mode = _build.noise_mode(noise_on, normals)
    _check(cfg, p_rows, lw, z, normals)
    _check_gate(gate, p_alt, p_rows, with_stats)
    return _launch(cfg, seed, flag, p_rows, lw, z, mode, normals,
                   with_stats, gate, p_alt)


def _launch(cfg: PfConfig, seed: int, flag: float, p_rows: torch.Tensor,
            lw: torch.Tensor, z: torch.Tensor, mode: int,
            normals: torch.Tensor | None, with_stats: bool,
            gate: torch.Tensor | None, p_alt: torch.Tensor | None):
    """K2's launch on checked arguments, into fresh outputs."""
    plan = _plan(cfg, lw.device)
    p_out, lw_out = torch.empty_like(p_rows), torch.empty_like(lw)
    stats = (torch.empty(_STATS_LEN, dtype=torch.float32, device=lw.device)
             if with_stats else None)
    ptr = _build.ptr
    _build.launch("pf_step", plan.entry, plan.index, p_rows.data_ptr(),
                  lw.data_ptr(), z.data_ptr(), ptr(normals), p_out.data_ptr(),
                  lw_out.data_ptr(), ptr(stats), plan.params_ptr,
                  *_build.seed_words(seed), float(flag), mode,
                  int(with_stats), ptr(gate), ptr(p_alt))
    return p_out, lw_out, stats


def ticket_count(device: torch.device | str) -> int:
    """K2b's ticket counter on ``device`` (0 between launches; a launch
    that ends leaves it at 0).  Reads the device: for checks only."""
    return _build.read_word("tpuslam_pf_step_ticket", device)


def _step_rows(cfg: PfConfig, seed: int, flag: float, p_rows: torch.Tensor,
               lw: torch.Tensor, z: torch.Tensor, noise_on: bool,
               normals: torch.Tensor | None, with_stats: bool, plain: bool,
               gate: torch.Tensor | None = None,
               p_alt: torch.Tensor | None = None):
    """:func:`pf_step_rows` or, with ``plain``, its twin: returns
    ``(p_rows', lw')`` and, ``with_stats``, also the ``(10,)``
    statistics."""
    step = pf_step_rows_plain if plain else pf_step_rows
    out = step(cfg, seed, flag, p_rows, lw, z, noise_on, normals,
               with_stats, gate=gate, p_alt=p_alt)
    return out if with_stats else out[:2]


def _as_rows(particles: torch.Tensor) -> torch.Tensor:
    return particles.to(torch.float32).T.contiguous()


def _predict_weight(cfg, seed, particles, log_w, z, noise_on, normals,
                    plain):
    p_rows, lw = _step_rows(cfg, seed, 0.0, _as_rows(particles),
                            log_w.to(torch.float32), z, noise_on, normals,
                            False, plain)
    return p_rows.T, lw


def pf_fused_predict_weight(cfg: PfConfig, seed: int,
                            particles: torch.Tensor, log_w: torch.Tensor,
                            z: torch.Tensor, noise_on: bool = True,
                            normals: torch.Tensor | None = None):
    """K2a: fused predict + log-likelihood weight update.

    Args:
        seed: key of the kernel's Philox stream.
        particles: ``(NP, 3)``; log_w: ``(NP,)`` unnormalized log weights.
        z: ``(L, 2)`` robot-frame landmark observation.
        normals: optional ``(3, NP)`` standard normals in place of the
            Philox stream (noise on only).

    Returns:
        ``(particles', log_w')`` with the same shapes (``log_w'``
        unnormalized).
    """
    return _predict_weight(cfg, seed, particles, log_w, z, noise_on,
                           normals, plain=False)


def pf_fused_predict_weight_plain(cfg: PfConfig, seed: int,
                                  particles: torch.Tensor,
                                  log_w: torch.Tensor, z: torch.Tensor,
                                  noise_on: bool = True,
                                  normals: torch.Tensor | None = None):
    """Plain twin of :func:`pf_fused_predict_weight`, on any device."""
    return _predict_weight(cfg, seed, particles, log_w, z, noise_on,
                           normals, plain=True)


def _predict_weight_stats(cfg, seed, uniform_flag, particles, log_w, z,
                          noise_on, normals, plain):
    p_rows, lw, stats = _step_rows(
        cfg, seed, float(uniform_flag), _as_rows(particles),
        log_w.to(torch.float32), z, noise_on, normals, True, plain)
    return p_rows.T, lw, stats[:6]


def pf_fused_predict_weight_stats(cfg: PfConfig, seed: int, uniform_flag,
                                  particles: torch.Tensor,
                                  log_w: torch.Tensor, z: torch.Tensor,
                                  noise_on: bool = True,
                                  normals: torch.Tensor | None = None):
    """K2b: :func:`pf_fused_predict_weight` plus the step's reductions
    in the same pass.

    Args:
        uniform_flag: > 0 treats the incoming ``log_w`` as uniform zeros
            (the lazy NaN->uniform reset).

    Returns:
        ``(particles', log_w', stats)`` where ``stats`` is ``(6,)``
        ``[lse, lse2, x_map, y_map, yaw_map, best_lw]``: the logsumexp of
        ``log_w'`` and of ``2 log_w'``, and the max-weight particle (the
        highest index among equal maxima).
    """
    return _predict_weight_stats(cfg, seed, uniform_flag, particles, log_w,
                                 z, noise_on, normals, plain=False)


def pf_fused_predict_weight_stats_plain(cfg: PfConfig, seed: int,
                                        uniform_flag,
                                        particles: torch.Tensor,
                                        log_w: torch.Tensor,
                                        z: torch.Tensor,
                                        noise_on: bool = True,
                                        normals: torch.Tensor | None = None):
    """Plain twin of :func:`pf_fused_predict_weight_stats`, on any
    device."""
    return _predict_weight_stats(cfg, seed, uniform_flag, particles, log_w,
                                 z, noise_on, normals, plain=True)


def pf_fused_init(cfg: PfConfig, state0: PfState | None = None, *,
                  device: torch.device | str) -> PfFusedState:
    """Lift a :class:`PfState` (default :func:`pf_init`) into the fused
    representation on ``device``."""
    device = _build.resolve_device(device)
    if state0 is None:
        state0 = pf_init(cfg, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    weights = state0.weights.to(**f32)
    lw = torch.log(torch.clamp(weights, min=1e-38))
    particles = state0.particles.to(**f32)
    best = torch.argmax(weights).reshape(1)  # a device index: no host read
    return PfFusedState(
        x_true=state0.x_true.to(**f32), particles=particles.T.contiguous(),
        log_w=lw, lse=torch.logsumexp(lw, dim=0),
        lse2=torch.logsumexp(2.0 * lw, dim=0),
        x_est=particles.index_select(0, best)[0])


def pf_fused_to_state(cfg: PfConfig, fs: PfFusedState) -> PfState:
    """Normalized weights (NaN->uniform, particle_filter.py:226-237) back
    in a :class:`PfState`."""
    return PfState(x_true=fs.x_true, particles=fs.particles.T,
                   weights=weights_from_log(cfg, fs.log_w, fs.lse))


def _ess(cfg: PfConfig, lse: torch.Tensor, lse2: torch.Tensor):
    """``(bad, ess)`` of the carried normalizers: ``n`` where one is not
    finite (the NaN->uniform reset), ``exp(2 lse - lse2)`` elsewhere."""
    bad = ~(torch.isfinite(lse) & torch.isfinite(lse2))
    return bad, torch.where(bad, float(cfg.num_particles),
                            torch.exp(2.0 * lse - lse2))


def ess_min(cfg: PfConfig) -> float:
    """The gate's threshold ``n * ess_threshold_frac`` as float32, the
    value a float32 tensor is compared with."""
    return ctypes.c_float(cfg.num_particles * cfg.ess_threshold_frac).value


def _resample_gated(cfg, fs, offs, plain, merge_kw):
    """The merge on the device's gate: ``(p_alt, gate)``, no host read
    (:func:`~tpuslam_torch.ops.resample_cuda.merge_resample_gated`)."""
    merge = (resample_cuda.merge_resample_gated_plain if plain
             else resample_cuda.merge_resample_gated)
    return merge(fs.particles, fs.log_w, fs.lse, fs.lse2,
                 cfg.num_particles, offs, ess_min(cfg), **merge_kw)


def _resample_on_host(cfg, fs, offs):
    """The other methods' resample on the host's decision, one sync:
    ``(particles, log_w, flag)`` for the step, ``flag`` the NaN->uniform
    reset where the gate did not fire."""
    global sync_count
    bad, ess = _ess(cfg, fs.lse, fs.lse2)
    do_rs, is_bad = torch.stack([ess < ess_min(cfg), bad]).tolist()
    sync_count += 1
    if not do_rs:
        return fs.particles, fs.log_w, 1.0 if is_bad else 0.0
    w = torch.exp(fs.log_w - fs.lse)
    idx = resample_indices_from_offs(offs, w, cfg.resample_method)
    return fs.particles[:, idx], torch.zeros_like(fs.log_w), 0.0


def _step(cfg: PfConfig, fs: PfFusedState, x_true: torch.Tensor,
          z: torch.Tensor, seed: int, offs: torch.Tensor, noise_on: bool,
          normals: torch.Tensor | None, plain: bool, merge_kw: dict):
    """One step from the step's truth and observation: ESS gate,
    resample where it fires (the merge on the device's gate, with
    ``merge_kw`` from
    :func:`~tpuslam_torch.ops.resample_cuda.merge_options`; another
    method on the host's), then the stats pass and the estimate.
    Returns the next state and the merge's ``(2,)`` device gate (None for
    the other methods)."""
    with span("tpuslam.pf.resample"):
        if cfg.resample_method == "merge":
            p_alt, gate = _resample_gated(cfg, fs, offs, plain, merge_kw)
            particles, log_w, flag = fs.particles, fs.log_w, 0.0
        else:
            particles, log_w, flag = _resample_on_host(cfg, fs, offs)
            p_alt = gate = None
    # The lazy NaN->uniform reset and the restart after a resample ride the
    # kernel's read of log_w.
    particles, log_w, stats = _step_rows(
        cfg, seed, flag, particles, log_w, z, noise_on, normals, True, plain,
        gate, p_alt)
    lse = stats[0]

    if cfg.estimate == "mean":
        weights = weights_from_log(cfg, log_w, lse)
        x, y, yaw = particles
        x_est = torch.stack([
            torch.sum(weights * x), torch.sum(weights * y),
            torch.atan2(torch.sum(weights * torch.sin(yaw)),
                        torch.sum(weights * torch.cos(yaw)))])
    else:
        x_est = stats[7:10]
    return PfFusedState(x_true=x_true, particles=particles, log_w=log_w,
                        lse=lse, lse2=stats[1], x_est=x_est), gate


def _draws(cfg: PfConfig, generator: torch.Generator | None, n_steps: int,
           offs, obs_noise, device: torch.device):
    """The comb offsets ``(n_steps,)`` and scaled observation noise
    ``(n_steps, L, 2)``: the caller's, or drawn from ``generator``."""
    f32 = dict(dtype=torch.float32, device=device)
    n_lm = len(cfg.landmarks)
    if offs is None:
        offs = torch.rand((n_steps,), generator=generator, **f32)
    else:
        offs = torch.as_tensor(offs, **f32).reshape(n_steps)
    if obs_noise is None:
        obs_noise = torch.randn((n_steps, n_lm, 2), generator=generator,
                                **f32)
        obs_noise = obs_noise * _build.device_constant(cfg.r_std, obs_noise)
    else:
        obs_noise = torch.as_tensor(obs_noise, **f32).reshape(n_steps, n_lm,
                                                              2)
    return offs, obs_noise


def _observe(cfg: PfConfig, x_true: torch.Tensor) -> torch.Tensor:
    return world_to_robot(x_true, _build.device_constant(cfg.landmarks,
                                                         x_true))


def _step_stats(cfg, fs, generator, seed, noise_on, offs, obs_noise,
                normals, plain, merge_caps_kw):
    merge_kw = resample_cuda.merge_options(merge_caps_kw)
    offs, obs_noise = _draws(cfg, generator, 1, offs, obs_noise,
                             fs.particles.device)
    x_true = circular_step(fs.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)
    z = (_observe(cfg, x_true) + obs_noise[0]).contiguous()
    return (_step(cfg, fs, x_true, z, seed, offs[0], noise_on, normals,
                  plain, merge_kw)[0], _ess(cfg, fs.lse, fs.lse2)[1])


def pf_fused_step_stats(cfg: PfConfig, fs: PfFusedState,
                        generator: torch.Generator | None, seed: int,
                        noise_on: bool = True, *, offs=None, obs_noise=None,
                        normals: torch.Tensor | None = None,
                        merge_caps_kw: tuple = ()):
    """One PF step on the fused state, one pass over particle memory
    unless the ESS gate fires.

    Semantics of ``pf_step`` in log-weight mode (resample -> predict ->
    observe -> weight -> normalize -> estimate), with the normalization,
    the ESS and the MAP estimate from the kernel's reductions.  With
    ``resample_method="merge"`` the resample runs
    :func:`~tpuslam_torch.ops.resample_cuda.merge_resample_gated` on the
    device's gate (no host read); the other methods decide on the host.

    Args:
        generator: draws the comb offset and the observation noise (on
            the state's device) where ``offs`` / ``obs_noise`` are not
            given.
        seed: key of the kernel's Philox particle-noise stream.
        offs: optional comb offset in [0, 1).
        obs_noise: optional ``(L, 2)`` scaled observation noise.
        normals: optional ``(3, N)`` standard normals for the particle
            noise (noise on only).
        merge_caps_kw: the JAX package's ``(name, value)`` pairs for the
            merge; ``("pass2", str)`` chooses its path
            (:func:`.resample_cuda.merge_resample_rows`), ``("fused",
            True)`` is accepted as what the port always does, and any
            other entry raises a ``ValueError``
            (:func:`.resample_cuda.merge_options`).

    Returns:
        ``(next_fs, ess)`` with the ESS before resampling.
    """
    return _step_stats(cfg, fs, generator, seed, noise_on, offs, obs_noise,
                       normals, plain=False, merge_caps_kw=merge_caps_kw)


def pf_fused_step_stats_plain(cfg: PfConfig, fs: PfFusedState,
                              generator: torch.Generator | None, seed: int,
                              noise_on: bool = True, *, offs=None,
                              obs_noise=None,
                              normals: torch.Tensor | None = None,
                              merge_caps_kw: tuple = ()):
    """:func:`pf_fused_step_stats` through the plain twins only, on any
    device."""
    return _step_stats(cfg, fs, generator, seed, noise_on, offs, obs_noise,
                       normals, plain=True, merge_caps_kw=merge_caps_kw)


def pf_fused_step(cfg: PfConfig, state: PfState,
                  generator: torch.Generator | None, seed: int,
                  noise_on: bool = True, *, offs=None, obs_noise=None):
    """One fused PF step with a :class:`PfState` in and out, on the
    state's device (see :func:`pf_fused_step_stats`).

    Returns ``(next_state, ess)``.
    """
    fs = pf_fused_init(cfg, state, device=state.particles.device)
    fs, ess = pf_fused_step_stats(cfg, fs, generator, seed, noise_on,
                                  offs=offs, obs_noise=obs_noise)
    return pf_fused_to_state(cfg, fs), ess


def truth_table(cfg: PfConfig, x_true0: torch.Tensor, n_steps: int):
    """``(x_true, z_clean)``: the ``(n_steps, 3)`` ground truth after each
    step from ``x_true0`` and the ``(n_steps, L, 2)`` noise-free
    observation of the landmarks from it, by the plain torch ops of the
    circular step on ``x_true0``'s device.
    """
    rows, x = [], x_true0
    for _ in range(n_steps):
        x = circular_step(x, cfg.vel, cfg.yaw_rate, cfg.dt)
        rows.append(x)
    x_tbl = torch.stack(rows)
    return x_tbl, _observe(cfg, x_tbl)


def _truth_tables(cfg: PfConfig, fs: PfFusedState, n_steps: int,
                  from_x0: bool):
    """:func:`truth_table` from the state's truth.  From ``cfg.x0`` the
    tables are the same for every rollout, so ``_build``'s cache keeps
    them by ``(cfg, n_steps, device)``, as the EKF's; a caller's own
    start state gets fresh tables."""
    if not from_x0:
        return truth_table(cfg, fs.x_true, n_steps)
    return _build.cached(("pf_truth", cfg, n_steps, fs.x_true.device),
                         lambda: truth_table(cfg, fs.x_true, n_steps))


def _rollout(cfg, generator, n_steps, state0, noise_on, device, offs,
             obs_noise, plain, merge_caps_kw, gates):
    with span("tpuslam.pf.rollout"):
        with span("tpuslam.pf.prepare"):
            device = _build.resolve_device(device)
            if n_steps < 1:
                raise ValueError(f"n_steps {n_steps} must be positive")
            merge_kw = resample_cuda.merge_options(merge_caps_kw)
            if device.type == "cuda" and not plain:
                _build.cuda_library(device)
            fs = pf_fused_init(cfg, state0, device=device)
            x_tbl, z_clean = _truth_tables(cfg, fs, n_steps, state0 is None)
            offs, obs_noise = _draws(cfg, generator, n_steps, offs,
                                     obs_noise, device)
            z_all = (z_clean + obs_noise).contiguous()
            seed = SEED0
            x_est = []
        for k in range(n_steps):
            with span("tpuslam.pf.step"):
                fs, gate = _step(cfg, fs, x_tbl[k], z_all[k], seed, offs[k],
                                 noise_on, None, plain, merge_kw)
                x_est.append(fs.x_est)
                if gates is not None:
                    gates.append(gate)
                seed += SEED_STEP
        return pf_fused_to_state(cfg, fs), (x_tbl, torch.stack(x_est))


def pf_fused_rollout(cfg: PfConfig, generator: torch.Generator | None,
                     n_steps: int, state0: PfState | None = None,
                     noise_on: bool = True, *, device: torch.device | str,
                     offs=None, obs_noise=None, merge_caps_kw: tuple = (),
                     gates: list | None = None):
    """``n_steps`` fused PF steps (the path of ``bench.py``'s
    ``bench_pf_pallas``).

    The kernel's seed starts at :data:`SEED0` and advances by
    :data:`SEED_STEP` a step, as in the JAX package.

    Args:
        generator: draws the comb offsets and observation noise where
            ``offs`` / ``obs_noise`` are not given; on ``device``.
        state0: initial state (default :func:`pf_init`).
        device: required; a CUDA device launches the kernels, the CPU
            runs the plain twins.  There is no default, so no caller
            lands on the plain path by leaving it out.
        offs: optional ``(n_steps,)`` comb offsets.
        obs_noise: optional ``(n_steps, L, 2)`` scaled observation noise.
        merge_caps_kw: the merge's path, as in
            :func:`pf_fused_step_stats`.
        gates: optional list that collects each step's ``(2,)`` device
            gate ``[fire, restart]`` (the merge method's; None for the
            others), to be read after the rollout: the rollout itself
            reads none.

    Returns:
        ``(final_state, (x_true, x_est))`` with ``(n_steps, 3)``
        trajectories.
    """
    return _rollout(cfg, generator, n_steps, state0, noise_on, device, offs,
                    obs_noise, plain=False, merge_caps_kw=merge_caps_kw,
                    gates=gates)


def pf_fused_rollout_plain(cfg: PfConfig,
                           generator: torch.Generator | None, n_steps: int,
                           state0: PfState | None = None,
                           noise_on: bool = True, *,
                           device: torch.device | str, offs=None,
                           obs_noise=None, merge_caps_kw: tuple = (),
                           gates: list | None = None):
    """:func:`pf_fused_rollout` through the plain twins only, on any
    device."""
    return _rollout(cfg, generator, n_steps, state0, noise_on, device, offs,
                    obs_noise, plain=True, merge_caps_kw=merge_caps_kw,
                    gates=gates)
