"""The plain reference of particle-filter localisation.

The reference's particle_filter.py in log-weight form: each step the ESS
gate (``ESS < n * ess_frac``, particle_filter.py:33,211) decides a
systematic resample, then every particle moves by the circular motion
with process noise, its log weight gains the log-likelihood of the
landmark observation, and the estimate is the particle of largest weight
(the highest index among equal maxima).  The truth is noise-free; the
observation is the landmarks in the true robot frame plus the call's
observation noise.

Two laws, as the program under test documents them:

* ``single`` (one filter, ``pf_fused_rollout`` with the merge resample):
  log weights are carried unnormalized and restart at 0 after a resample
  or where a normalizer is not finite; the resample quantizes the weights
  to integers of ``2^-20`` of their total; the comb offsets are the
  call's; particle ``j`` draws its noise from Philox counter
  ``(j, 0, 0, 0)``.
* ``batched`` (``pf_batch_rollout``): log weights are normalized every
  step and restart at ``-log n``; the resample quantizes ``w * 2^20``;
  filter ``f``'s comb offset is the Philox counter ``(0, f, 1, 0)`` and
  its particle ``j`` draws from ``(j, f, 0, 0)``.

In both, the resample is the interval decode of the slot boundaries
``t_j = ceil(n * cum_j / cum_n - offs)`` (clipped to ``[0, n]``, the last
forced to ``n``): slot ``i`` takes particle ``#{j : t_j <= i}``.  Step
``k``'s Philox key is ``1 + 7919 k``.

The reference computes any subset of a batch's filters (their indices key
the noise) in any float dtype.
"""

from __future__ import annotations

import math

import torch

from reference.ekf import wrap
from reference.philox import box_muller, philox, unit

SEED0, SEED_STEP = 1, 7919
QUANTUM = float(1 << 20)


def truth_obs(scene: dict, n_steps: int, dtype: torch.dtype,
              device: torch.device):
    """``(x_true, z_clean)``: the ``(T, 3)`` truth after each step and the
    ``(T, L, 2)`` noise-free robot-frame landmark observations."""
    vdt = scene["radius_m"] * scene["yaw_rate"] * scene["dt"]
    wdt = scene["yaw_rate"] * scene["dt"]
    x = torch.tensor(scene["x0"], dtype=dtype, device=device)
    t0, t1, t2 = x[0], x[1], x[2]
    rows = []
    for _ in range(n_steps):
        t0 = t0 + vdt * torch.cos(t2)
        t1 = t1 + vdt * torch.sin(t2)
        t2 = wrap(t2 + wdt)
        rows.append(torch.stack([t0, t1, t2]))
    xt = torch.stack(rows)
    lm = torch.tensor(scene["landmarks"], dtype=dtype, device=device)
    ang = math.pi / 2.0 - xt[:, 2, None]
    c, s = torch.cos(ang), torch.sin(ang)
    dx = lm[None, :, 0] - xt[:, 0, None]
    dy = lm[None, :, 1] - xt[:, 1, None]
    return xt, torch.stack([c * dx - s * dy, s * dx + c * dy], dim=-1)


def _logsumexp(v: torch.Tensor) -> torch.Tensor:
    m = v.max(dim=-1).values
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return shift + torch.log(torch.exp(v - shift[:, None]).sum(dim=-1))


def _resample(lw, lse, offs, n: int, law: str):
    """Each filter's source particle for every slot ``(F, n)``."""
    w = torch.exp(lw - lse[:, None])
    if law == "single":
        q = torch.round(w * (QUANTUM / w.sum(dim=-1, keepdim=True)))
    else:
        q = torch.round(w * QUANTUM)
    cum = torch.cumsum(q, dim=-1)
    t = torch.ceil(n * (cum * (1.0 / cum[:, -1:])) - offs[:, None])
    t = t.clamp(0, n).to(torch.int64)
    t[:, n - 1:] = n
    slots = torch.arange(n, device=lw.device).expand_as(t).contiguous()
    return torch.searchsorted(t.contiguous(), slots, right=True).clamp(
        max=n - 1)


def filters(scene: dict, law: str, n: int, filt: torch.Tensor,
            n_steps: int, obs_noise: torch.Tensor,
            offs: torch.Tensor | None, dtype: torch.dtype) -> dict:
    """Run the filters numbered ``filt`` for ``n_steps``.

    Args:
        law: ``"single"`` or ``"batched"`` (module docstring).
        n: particles a filter.
        filt: ``(F,)`` int64 filter indices (``[0]`` for the single
            filter).
        obs_noise: ``(T, F, L, 2)`` scaled observation noise.
        offs: ``(T,)`` comb offsets of the single law (None: batched).

    Returns a dict: ``x_est (T, F, 3)``, the truth ``x_true (T, 3)``,
    the final ``particles (F, n, 3)`` and ``log_w (F, n)``, and
    ``fired (T, F)`` bool.
    """
    dev = filt.device
    vdt = scene["radius_m"] * scene["yaw_rate"] * scene["dt"]
    wdt = scene["yaw_rate"] * scene["dt"]
    q0, q1, q2 = scene["q_std"]
    sx, sy = scene["r_std"]
    log_norm = math.log(2.0 * math.pi * sx * sy)
    ess_min = n * scene["ess_threshold_frac"]
    lm = scene["landmarks"]
    x_true, z_clean = truth_obs(scene, n_steps, dtype, dev)
    z_all = z_clean[:, None] + obs_noise.to(dtype)
    n_f = filt.shape[0]
    x0 = scene["x0"]
    x, y, yaw = (torch.full((n_f, n), v, dtype=dtype, device=dev)
                 for v in x0)
    lw = torch.full((n_f, n), -math.log(n), dtype=dtype, device=dev)
    lse, lse2 = _logsumexp(lw), _logsumexp(2.0 * lw)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    est, fired = [], []
    for k in range(n_steps):
        key = SEED0 + SEED_STEP * k
        bad = ~(torch.isfinite(lse) & torch.isfinite(lse2))
        ess = torch.where(bad, torch.full_like(lse, n),
                          torch.exp(2.0 * lse - lse2))
        fire = ~bad & (ess < ess_min)
        if law == "single":
            off = offs[k].to(dtype).expand(n_f)
            lw_cur = torch.where((bad | fire)[:, None],
                                 torch.zeros_like(lw), lw)
        else:
            off = unit(philox(0, filt, 1, 0, key)[0], dtype)
            lw_cur = torch.where(fire[:, None], -math.log(n),
                                 torch.where(bad[:, None], -math.log(n),
                                             lw - lse[:, None]))
        if bool(fire.any()):
            src = _resample(lw, lse, off, n, law)
            src = torch.where(fire[:, None], src, lane)
            x, y, yaw = (torch.take_along_dim(v, src, dim=1)
                         for v in (x, y, yaw))
        fired.append(fire)

        a = philox(lane[None, :], filt[:, None], 0, 0, key)
        n0, n1 = box_muller(a[0], a[1], dtype)
        n2, _ = box_muller(a[2], a[3], dtype)
        x = x + vdt * torch.cos(yaw) + n0 * q0
        y = y + vdt * torch.sin(yaw) + n1 * q1
        yaw = wrap(yaw + wdt) + n2 * q2
        # The robot frame turns by pi/2 - yaw: (cos, sin) = (sin, cos) yaw.
        c, s = torch.sin(yaw), torch.cos(yaw)
        acc = torch.zeros_like(x)
        z = z_all[k]
        for li, (lx, ly) in enumerate(lm):
            dx, dy = lx - x, ly - y
            ex = (c * dx - s * dy - z[:, li, 0, None]) / sx
            ey = (s * dx + c * dy - z[:, li, 1, None]) / sy
            acc = acc - 0.5 * (ex * ex + ey * ey) - log_norm
        lw = lw_cur + acc
        lse, lse2 = _logsumexp(lw), _logsumexp(2.0 * lw)
        key_lw = torch.where(torch.isnan(lw), -math.inf, lw)
        top = key_lw.max(dim=-1, keepdim=True).values
        best = torch.where(key_lw == top, lane, -1).max(dim=-1).values
        best = torch.where(torch.isfinite(lse), best, 0)[:, None]
        est.append(torch.stack([torch.take_along_dim(v, best, dim=1)[:, 0]
                                for v in (x, y, yaw)], dim=-1))
    return {"x_est": torch.stack(est), "x_true": x_true, "particles":
            torch.stack([x, y, yaw], dim=-1), "log_w": lw,
            "fired": torch.stack(fired)}
