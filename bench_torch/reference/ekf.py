"""The plain reference of the EKF Monte-Carlo sweep.

``rollouts`` independent robots drive the reference's circle
(extended_kalman_filter.py): the truth is noise-free; the observation is
the truth's position plus noise in the robot's frame; dead reckoning and
the filter's prediction run the circular motion model; the filter updates
on the position observation.  A rollout's noise is the documented Philox
stream of the program under test: under the call's key, step ``k`` of
rollout ``r`` reads the counter ``(r, k, 0, 0)`` for its observation pair
and its dead reckoning's x, y pair, and at even ``k`` the counter
``(r, k, 1, 0)``, whose first pair gives the yaw noise of steps ``k`` and
``k + 1``.

The reference computes any subset of the rollouts (their indices key the
noise), in any float dtype, one step at a time over the subset.
"""

from __future__ import annotations

import math

import torch

from reference.philox import box_muller, philox

TWO_PI = 2.0 * math.pi


def wrap(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``limit_angle`` loop in closed form."""
    mag = a.abs()
    k = torch.clamp(torch.ceil((mag - math.pi) / TWO_PI), min=0.0)
    w = mag - TWO_PI * k
    return torch.where(a < 0, -w, w)


def truth(scene: dict, n_steps: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """``(n_steps, 3)`` truth after each step of the circular motion."""
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
    return torch.stack(rows)


#: Steps whose noise is drawn at once (even, so a yaw pair stays in one).
_BLOCK = 128


def normals(key: int, idx: torch.Tensor, k0: int, k1: int,
            dtype: torch.dtype) -> torch.Tensor:
    """``(k1 - k0, 5, len(idx))`` normals of steps ``k0 <= k < k1`` (``k0``
    even): the observation's x, y, the dead reckoning's x, y, yaw."""
    ks = torch.arange(k0, k1, dtype=torch.int64, device=idx.device)[:, None]
    a = philox(idx[None, :], ks, 0, 0, key)
    n0, n1 = box_muller(a[0], a[1], dtype)
    n2, n3 = box_muller(a[2], a[3], dtype)
    b = philox(idx[None, :], ks[::2], 1, 0, key)
    y_even, y_odd = box_muller(b[0], b[1], dtype)
    n4 = torch.stack([y_even, y_odd], dim=1).reshape(-1, idx.shape[0])
    return torch.stack([n0, n1, n2, n3, n4[:k1 - k0]], dim=1)


def rollouts(scene: dict, key: int, idx: torch.Tensor, n_steps: int,
             noise_on: bool, dtype: torch.dtype) -> dict:
    """The rollouts numbered ``idx`` of a sweep under ``key``.

    Returns a dict of ``(len(idx), ...)`` tensors: ``x_true``, ``x_dr``,
    ``x_hat`` (final poses), ``cov`` (final ``3 x 3`` covariance), the
    summed squared posterior position error ``sq_err`` and the summed
    posterior position NEES ``nees``.
    """
    dev = idx.device
    vdt = scene["radius_m"] * scene["yaw_rate"] * scene["dt"]
    wdt = scene["yaw_rate"] * scene["dt"]
    q = [s * s for s in scene["q_std"]]
    r2 = [s * s for s in scene["r_std"]]
    qa, ra = scene["q_act_std"], scene["r_act_std"]
    p0 = [s * s for s in scene["p0_std"]]
    tbl = truth(scene, n_steps, dtype, dev)
    m = idx.shape[0]

    def full(v):
        return torch.full((m,), v, dtype=dtype, device=dev)

    xd = [full(v) for v in scene["x0"]]
    xh = list(xd)
    zero = full(0.0)
    p = [[full(p0[0]), zero, zero], [zero, full(p0[1]), zero],
         [zero, zero, full(p0[2])]]
    sq = zero
    nees = zero
    for k in range(n_steps):
        if not noise_on:
            n0 = n1 = n2 = n3 = n4 = zero
        else:
            if k % _BLOCK == 0:
                block = normals(key, idx, k, min(n_steps, k + _BLOCK), dtype)
            n0, n1, n2, n3, n4 = block[k % _BLOCK]
        xt0, xt1, xt2 = tbl[k]
        ct, st = torch.cos(xt2), torch.sin(xt2)
        wx, wy = n0 * ra[0], n1 * ra[1]
        z0 = st * wx + ct * wy + xt0
        z1 = -ct * wx + st * wy + xt1

        xd = [xd[0] + vdt * torch.cos(xd[2]) + n2 * qa[0],
              xd[1] + vdt * torch.sin(xd[2]) + n3 * qa[1],
              wrap(xd[2] + wdt + n4 * qa[2])]

        ch, sh = torch.cos(xh[2]), torch.sin(xh[2])
        xp = [xh[0] + vdt * ch, xh[1] + vdt * sh, wrap(xh[2] + wdt)]
        # P = F P F^T + Q with F = [[1, 0, a], [0, 1, b], [0, 0, 1]].
        fa, fb = -vdt * sh, vdt * ch
        fp = [[p[0][j] + fa * p[2][j] for j in range(3)],
              [p[1][j] + fb * p[2][j] for j in range(3)], p[2]]
        p = [[fp[i][0] + fa * fp[i][2], fp[i][1] + fb * fp[i][2], fp[i][2]]
             for i in range(3)]
        p[0][0] = p[0][0] + q[0]
        p[1][1] = p[1][1] + q[1]
        p[2][2] = p[2][2] + q[2]

        # Position observation: H = [I2 0]; S = P[:2, :2] + R.
        s00, s01 = p[0][0] + r2[0], p[0][1]
        s10, s11 = p[1][0], p[1][1] + r2[1]
        det = s00 * s11 - s01 * s10
        i00, i01, i10, i11 = s11 / det, -s01 / det, -s10 / det, s00 / det
        g = [[p[i][0] * i00 + p[i][1] * i10, p[i][0] * i01 + p[i][1] * i11]
             for i in range(3)]
        e0, e1 = z0 - xp[0], z1 - xp[1]
        xh = [xp[0] + g[0][0] * e0 + g[0][1] * e1,
              xp[1] + g[1][0] * e0 + g[1][1] * e1,
              wrap(xp[2] + g[2][0] * e0 + g[2][1] * e1)]
        p = [[p[i][j] - (g[i][0] * p[0][j] + g[i][1] * p[1][j])
              for j in range(3)] for i in range(3)]

        d0, d1 = xh[0] - xt0, xh[1] - xt1
        sq = sq + d0 * d0 + d1 * d1
        det_n = p[0][0] * p[1][1] - p[0][1] * p[1][0]
        nees = nees + (p[1][1] * d0 * d0 - (p[0][1] + p[1][0]) * d0 * d1
                       + p[0][0] * d1 * d1) / det_n
    last = tbl[-1].expand(m, 3)
    return {"x_true": last, "x_dr": torch.stack(xd, dim=1),
            "x_hat": torch.stack(xh, dim=1),
            "cov": torch.stack([torch.stack(row, dim=1) for row in p],
                               dim=1),
            "sq_err": sq, "nees": nees}
