"""The plain reference of the wide particle filter: B filters of any size
(10,000 particles in the benchmark), the law that
``pf_batch_wide_rollout`` documents.

The reference's particle_filter.py in log-weight form, as
:mod:`reference.pf` computes it, with the wide law's own choices.  Its
departures from particle_filter.py:

* weights live as log weights carried unnormalized, with their
  normalizers ``lse = logsumexp(lw)`` and ``lse2 = logsumexp(2 lw)``; a
  filter starts with log weights 0 and ``lse = lse2 = log n``
  (particle_filter.py multiplies raw likelihoods into weights and
  normalizes them every step);
* each step opens with the ESS gate on the carried normalizers, ``ESS =
  exp(2 lse - lse2) < n * ess_frac`` (particle_filter.py:33,211 takes
  the ESS of the normalized weights at the end of a step, which is the
  same number); a filter whose normalizers are not finite does not
  resample and restarts its log weights at 0;
* a firing filter's resample is the systematic comb of the call's offset
  ``offs[k, f]`` on its weights ``w = exp(lw - lse)`` quantized to
  integers of ``2^-20`` of their row total (``round(w * 2^20 / sum w)``,
  half to even), decoded by the interval law
  ``t_j = ceil(n * (cum_j * (1 / cum_n)) - offs)`` clipped to ``[0, n]``
  with the last forced to ``n``: slot ``i`` takes particle
  ``#{j : t_j <= i}`` (particle_filter.py:212-221 walks the comb on the
  float weights); its log weights then restart at 0, not ``-log n``
  (particle_filter.py sets every weight to ``1 / n``);
* particle ``j`` of filter ``f`` draws its three process normals from
  the Philox4x32-10 counter ``(j, f, 0, 0)`` under step ``k``'s key
  ``1 + k * max(7919, B * ceil(n / 1024))``, where ``B`` is the call's
  batch, not the number of filters computed here (particle_filter.py
  draws from numpy's global stream);
* the estimate is the particle of largest log weight, the highest index
  among equal maxima, a NaN never winning (particle_filter.py's
  ``calc_covariance`` and weighted mean are not computed).

The truth is noise-free; the observation is the landmarks in the true
robot frame plus the call's observation noise (:func:`reference.pf.truth_obs`).
The reference computes any subset of a call's filters (their indices key
the noise) in any float dtype, and never reads the program.
"""

from __future__ import annotations

import math

import torch

from reference.ekf import wrap
from reference.pf import _logsumexp, _resample, truth_obs
from reference.philox import box_muller, philox

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED0, SEED_STEP = 1, 7919
#: The wide filter's resample tile, which sets its seed stride.
TILE = 1024
#: Counters a Philox block draws at once (steps x filters x particles).
BLOCK_DRAWS = 1 << 24


def seed_step(n: int, batch: int) -> int:
    """The key's advance a step for ``batch`` filters of ``n``."""
    return max(SEED_STEP, batch * -(-n // TILE))


def filters(scene: dict, n: int, batch: int, filt: torch.Tensor,
            n_steps: int, obs_noise: torch.Tensor, offs: torch.Tensor,
            dtype: torch.dtype) -> dict:
    """Run the filters numbered ``filt`` of a call of ``batch`` filters of
    ``n`` particles for ``n_steps``.

    Args:
        filt: ``(F,)`` int64 filter indices, each below ``batch``.
        obs_noise: ``(T, F, L, 2)`` scaled observation noise of those
            filters.
        offs: ``(T, F)`` their comb offsets in [0, 1).

    Returns a dict: ``x_est (T, F, 3)``, the truth ``x_true (T, 3)``,
    ``lse (T, F)`` the normalizer after each step, ``fired (T, F)`` bool,
    the final ``particles (F, n, 3)`` and ``log_w (F, n)``.
    """
    dev = filt.device
    vdt = scene["radius_m"] * scene["yaw_rate"] * scene["dt"]
    wdt = scene["yaw_rate"] * scene["dt"]
    q0, q1, q2 = scene["q_std"]
    sx, sy = scene["r_std"]
    log_norm = math.log(2.0 * math.pi * sx * sy)
    ess_min = n * scene["ess_threshold_frac"]
    lm = torch.tensor(scene["landmarks"], dtype=dtype, device=dev)
    lmx, lmy = lm[:, 0, None, None], lm[:, 1, None, None]  # (L, 1, 1)
    x_true, z_clean = truth_obs(scene, n_steps, dtype, dev)
    z_all = z_clean[:, None] + obs_noise.to(dtype)
    offs = offs.to(dtype)
    n_f = filt.shape[0]
    x, y, yaw = (torch.full((n_f, n), v, dtype=dtype, device=dev)
                 for v in scene["x0"])
    lw = torch.zeros((n_f, n), dtype=dtype, device=dev)
    lse = torch.full((n_f,), math.log(n), dtype=dtype, device=dev)
    lse2 = lse.clone()
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    keys = SEED0 + seed_step(n, batch) * torch.arange(
        n_steps, dtype=torch.int64, device=dev)
    # The steps' normals a block of steps at a time: one Philox call of a
    # (steps, F, n) counter block under a key a step.
    block = max(1, BLOCK_DRAWS // (n_f * n))
    est, fired, lses = [], [], []
    for k in range(n_steps):
        if k % block == 0:
            a = philox(lane[None, None, :], filt[None, :, None], 0, 0,
                       keys[k:k + block, None, None])
            n0s, n1s = box_muller(a[0], a[1], dtype)
            n2s, _ = box_muller(a[2], a[3], dtype)
        n0, n1, n2 = (v[k % block] for v in (n0s, n1s, n2s))
        bad = ~(torch.isfinite(lse) & torch.isfinite(lse2))
        ess = torch.where(bad, torch.full_like(lse, n),
                          torch.exp(2.0 * lse - lse2))
        fire = ~bad & (ess < ess_min)
        lw_cur = torch.where((bad | fire)[:, None], torch.zeros_like(lw), lw)
        if bool(fire.any()):
            # The quantization against the row total is reference.pf's
            # single law's.
            src = torch.where(fire[:, None],
                              _resample(lw, lse, offs[k], n, "single"), lane)
            x, y, yaw = (torch.take_along_dim(v, src, dim=1)
                         for v in (x, y, yaw))
        fired.append(fire)

        x = x + vdt * torch.cos(yaw) + n0 * q0
        y = y + vdt * torch.sin(yaw) + n1 * q1
        yaw = wrap(yaw + wdt) + n2 * q2
        # The robot frame turns by pi/2 - yaw: (cos, sin) = (sin, cos) yaw.
        # Every landmark at once: (L, F, n).
        c, s = torch.sin(yaw), torch.cos(yaw)
        dx, dy = lmx - x, lmy - y
        z = z_all[k].permute(1, 2, 0)[..., None]  # (L, 2, F, 1)
        ex = (c * dx - s * dy - z[:, 0]) / sx
        ey = (s * dx + c * dy - z[:, 1]) / sy
        lw = lw_cur + (-0.5 * (ex * ex + ey * ey) - log_norm).sum(dim=0)
        lse, lse2 = _logsumexp(lw), _logsumexp(2.0 * lw)
        lses.append(lse)
        key_lw = torch.where(torch.isnan(lw), -math.inf, lw)
        top = key_lw.max(dim=-1, keepdim=True).values
        best = torch.where(key_lw == top, lane, -1).max(dim=-1).values
        est.append(torch.stack([torch.take_along_dim(v, best[:, None],
                                                     dim=1)[:, 0]
                                for v in (x, y, yaw)], dim=-1))
    return {"x_est": torch.stack(est), "x_true": x_true,
            "lse": torch.stack(lses), "fired": torch.stack(fired),
            "particles": torch.stack([x, y, yaw], dim=-1), "log_w": lw}
