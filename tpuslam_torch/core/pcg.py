"""Shared preconditioned-CG routine.

Port of ``tpuslam/core/pcg.py``: one implementation of the PCG iteration,
its stopping rule and its breakdown guards, parameterized by
``(matvec, precond, dot)``.

The JAX package's ``lax.while_loop`` tests its condition on the device.
A torch loop that read the condition every iteration would make one host
synchronisation an iteration.  This loop keeps the condition on the
device instead: each iteration computes the next iterate and keeps it
only where the condition held before the iteration (``torch.where``), and
the iteration count grows only there.  The host reads the condition every
``check_every`` iterations, so a solve of ``n`` iterations makes
``ceil(n / check_every)`` synchronisations at most, and runs at most
``check_every - 1`` iterations whose results it discards.  The iterate
and the count are those of the JAX routine.
"""

from __future__ import annotations

import torch

#: Iterations between the host's reads of the device-side condition.
CHECK_EVERY = 16


def pcg(matvec, precond, dot, b, max_iters: int, tol: float):
    """Preconditioned conjugate gradients on ``H x = b``.

    Args:
        matvec: ``x -> H x``.
        precond: ``r -> M^{-1} r``.
        dot: inner product ``(a, c) -> 0-dim tensor``.
        b: right-hand side tensor (any shape).
        max_iters / tol: stop when ``dot(r, r) <= tol * dot(b, b)``.

    Returns:
        ``(x, iters)``, ``iters`` a 0-dim int32 tensor on ``b``'s device.
        Breakdown-proof as in the JAX package: vanishing curvature or a
        non-finite/negative ``r.z`` stops with the current iterate; a
        negligible ``b`` (norm^2 <= 1e-9) gives zero and no iteration; any
        non-finite solution entry is replaced by zero.
    """
    check_every = CHECK_EVERY
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    bnorm = dot(b, b)
    live = bnorm > 1e-9  # JAX: lax.cond(bnorm > 1e-9, run, zeros)
    rr_stop = tol * bnorm
    iters = torch.zeros((), dtype=torch.int32, device=b.device)

    def cond(r, rz):
        # The JAX condition less ``it < max_iters``, which the loop's
        # range keeps.
        return ((dot(r, r) > rr_stop) & (rz > 0.0) & torch.isfinite(rz)
                & live)

    go = cond(r, rz)
    for i in range(max_iters):
        if i and i % check_every == 0 and not bool(go):
            break
        hp = matvec(p)
        php = dot(p, hp)
        # A vanishing curvature direction (converged or semidefinite mode)
        # gives a zero step, not an overflow.
        alpha = torch.where(php > 1e-20, rz / torch.clamp_min(php, 1e-20),
                            0.0)
        x_new = x + alpha * p
        r_new = r - alpha * hp
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = torch.where(rz > 1e-30, rz_new / torch.clamp_min(rz, 1e-30),
                           0.0)
        p_new = z + beta * p
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        p = torch.where(go, p_new, p)
        rz = torch.where(go, rz_new, rz)
        iters = iters + go.to(torch.int32)
        go = cond(r, rz)
    x = torch.where(torch.isfinite(x), x, 0.0)
    return torch.where(live, x, 0.0), iters
