"""Block cyclic reduction: the banded solver of logarithmic depth.

Port of ``tpuslam/slam/cyclic.py``.  The same super-block tridiagonal
system as :mod:`tpuslam_torch.slam.tridiag`'s Thomas chain, solved in
``log2(N)`` levels instead of ``N`` sequential steps: each level
eliminates the odd-indexed blocks of every remaining pair at once (a
batched Cholesky and batched products over all of them),

  x_o = A_o^{-1} (b_o - U_left^T x_le - U_right x_ri),
  A'_e = A_e - U_l^T A_o^{-1} U_l - U_r A_o^{-1} U_r^T,

and recurses on the evens until one block remains; the back
substitution then undoes the levels.  About twice Thomas's arithmetic,
at depth ``log2(N)``.  The blocks are padded to a power of two with
decoupled identity blocks.

Each level is a handful of batched torch ops (cuSOLVER's batched
Cholesky, cuBLAS's batched triangular solves and products); nothing
reads the device.  The numerical guards are the Thomas path's: Jacobi
prescaling, symmetrised Schur complements, and an unchecked Cholesky
whose non-PD blocks give NaN, as JAX's does.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.slam.tridiag import (_flat_prescale, _flat_to_tridiag,
                                        band_to_tridiag, cholesky_nan,
                                        flat_rows_to_super,
                                        jacobi_prescale, pad_band, pad_flat,
                                        super_rows_to_flat)


def _cho_solve(chol, y):
    """``A^{-1} y`` from A's lower Cholesky factor (``scipy``'s
    ``cho_solve``): two batched triangular solves."""
    z = torch.linalg.solve_triangular(chol, y, upper=False)
    return torch.linalg.solve_triangular(chol.mT, z, upper=True)


def _cho_solve_batch(d, y):
    """Batched SPD solve via Cholesky: d ``(N, M, M)``, y ``(N, M,
    K)``; returns ``(chol, A^{-1} y)``."""
    chol = cholesky_nan(d)
    return chol, _cho_solve(chol, y)


@highest_matmul_precision
def block_cr_solve(diag, upper, b):
    """Solve the symmetric block-tridiagonal system ``diag[k] x_k +
    upper[k] x_{k+1} + upper[k-1]^T x_{k-1} = b_k`` (the convention of
    :func:`~tpuslam_torch.slam.tridiag.block_thomas_solve`) by cyclic
    reduction.

    Args:
        diag: ``(N, M, M)`` with N a power of two (pad with identity
            blocks); upper: ``(N-1, M, M)``; b: ``(N, M)``.

    Returns:
        ``(N, M)`` solution.
    """
    n, m = diag.shape[0], diag.shape[1]
    if n & (n - 1):
        raise ValueError(f"N={n} must be a power of two (pad first)")
    # u[k] = U_k, with U_{n-1} = 0 (no coupling past the end).
    u = torch.cat([upper, diag.new_zeros((1, m, m))], dim=0)

    # Forward: halve until one block remains.
    stack = []  # a level's (chol of the odd blocks, u_even, u_odd, b_odd)
    d, bb = diag, b
    while d.shape[0] > 1:
        d_e, d_o = d[0::2], d[1::2]
        u_e, u_o = u[0::2], u[1::2]  # U_{2p}, U_{2p+1} (the last is 0)
        b_e, b_o = bb[0::2], bb[1::2]

        # Each odd block's A_o^{-1} applied to [U_odd | U_even^T | b].
        rhs = torch.cat([u_o, u_e.mT, b_o[..., None]], dim=-1)
        chol_o, sol = _cho_solve_batch(d_o, rhs)
        w1 = sol[..., :m]  # A_o^{-1} U_odd
        w2 = sol[..., m:2 * m]  # A_o^{-1} U_even^T
        y_o = sol[..., 2 * m]  # A_o^{-1} b_odd

        # Even 2p's left neighbour is odd 2p-1, odd block p-1: the odd
        # terms shift down by one (p = 0 has none).
        left_t = u_o.mT @ w1  # U_o^T A_o^-1 U_o
        left_b = (u_o.mT @ y_o[..., None])[..., 0]  # U_o^T y_o
        left_t = torch.cat([d.new_zeros((1, m, m)), left_t[:-1]], dim=0)
        left_b = torch.cat([d.new_zeros((1, m)), left_b[:-1]], dim=0)
        right_t = u_e @ w2  # U_e A_o^-1 U_e^T
        right_b = (u_e @ y_o[..., None])[..., 0]

        d_new = d_e - left_t - right_t
        d_new = 0.5 * (d_new + d_new.mT)
        b_new = b_e - left_b - right_b
        # Coupling even 2p -> even 2p+2: -U_{2p} A_o^{-1} U_{2p+1}; the
        # last one takes U_{n-1} = 0, the zero end coupling.
        u_new = -(u_e @ w1)

        stack.append((chol_o, u_e, u_o, b_o))
        d, u, bb = d_new, u_new, b_new

    x = _cho_solve_batch(d, bb[..., None])[1][..., 0]  # (1, M)

    # Back substitution:
    # x_odd[p] = A_o^{-1} (b_o - U_{2p}^T x_e[p] - U_{2p+1} x_e[p+1]).
    for chol_o, u_e, u_o, b_o in reversed(stack):
        x_right = torch.cat([x[1:], x.new_zeros((1, m))], dim=0)
        rhs = (b_o - (u_e.mT @ x[..., None])[..., 0]
               - (u_o @ x_right[..., None])[..., 0])
        x_o = _cho_solve(chol_o, rhs[..., None])[..., 0]
        x = torch.stack([x, x_o], dim=1).reshape(2 * x.shape[0], m)
    return x


def _pick_super_size(band: int, t1: int) -> int:
    """The super-block size S of both layouts, the reference's rule: S
    in [band, 2 band] with the least power-of-two padding, among the S
    with ``3S <= 128`` where there are any (a TPU MXU tile; kept so that
    both packages pick the same S)."""
    base = max(band, 1)

    def waste(s_try):
        n_try = -(-t1 // s_try)
        n2 = 1 << max(n_try - 1, 0).bit_length()
        return n2 * s_try - t1

    cands = list(range(base, 2 * base + 1))
    tile_friendly = [s for s in cands if 3 * s <= 128]
    return min(tile_friendly or cands, key=waste)


def _pad_super_pow2(diag, upper, b_sup):
    """Pad the super-block count to a power of two with decoupled
    identity blocks in dense ``(N, 3S, 3S)`` space (their solution is
    exactly 0 for the zero rhs padding); ``upper`` has N entries."""
    n, s3 = diag.shape[0], diag.shape[1]
    n2 = 1 << max(n - 1, 0).bit_length()
    if n2 == n:
        return diag, upper, b_sup
    eye = torch.eye(s3, dtype=diag.dtype, device=diag.device)
    diag = torch.cat([diag, eye.expand(n2 - n, s3, s3)], dim=0)
    upper = torch.cat([upper, upper.new_zeros((n2 - n, s3, s3))], dim=0)
    b_sup = torch.cat([b_sup, b_sup.new_zeros((n2 - n, s3))], dim=0)
    return diag, upper, b_sup


@highest_matmul_precision
def banded_solve_cr_flat(h_flat, b_flat, band: int,
                         super_size: int | None = None):
    """Flat-layout twin of :func:`banded_solve_cr`: ``h_flat``
    ``((band+1)*9, T1)``, ``b_flat`` ``(3, T1)``, result ``(T1, 3)``.
    The power-of-two padding is applied to the dense super-blocks after
    densification."""
    t1 = h_flat.shape[1]
    if super_size is None:
        super_size = _pick_super_size(band, t1)
    h_flat, b_flat = pad_flat(h_flat, b_flat, super_size)
    h_s, b_s, s = _flat_prescale(h_flat, b_flat, band)
    diag, upper = _flat_to_tridiag(h_s, band, super_size)
    b_sup = flat_rows_to_super(b_s, super_size)
    # upper gets N entries (the last 0) before the padding, so the
    # padded blocks stay decoupled.
    s3 = diag.shape[1]
    upper_n = torch.cat([upper, diag.new_zeros((1, s3, s3))], dim=0)
    diag, upper_n, b_sup = _pad_super_pow2(diag, upper_n, b_sup)
    x = block_cr_solve(diag, upper_n[:-1], b_sup)
    x3 = super_rows_to_flat(x[:b_s.shape[1] // super_size],
                            super_size) * s
    return x3.T[:t1]


@highest_matmul_precision
def banded_solve_cr(h_band, b, super_size: int | None = None):
    """One-shot ``H x = b`` on ``(D, T1, 3, 3)`` storage, ``b`` ``(T1,
    3)``, by super-block re-tiling and cyclic reduction (the trajectory
    padded to a power-of-two count of super-blocks)."""
    d1, t1 = h_band.shape[0], h_band.shape[1]
    band = d1 - 1
    if super_size is None:
        super_size = _pick_super_size(band, t1)
    h_band, b = pad_band(h_band, b, super_size)
    n = h_band.shape[1] // super_size
    n_pow2 = 1 << max(n - 1, 0).bit_length()
    if n_pow2 > n:
        h_band, b = pad_band(h_band, b, n_pow2 * super_size)
    t_pad = h_band.shape[1]
    n = t_pad // super_size
    h_scaled, b_scaled, s = jacobi_prescale(h_band, b)
    diag, upper = band_to_tridiag(h_scaled, super_size)
    x = block_cr_solve(diag, upper, b_scaled.reshape(n, 3 * super_size))
    return (x.reshape(t_pad, 3) * s)[:t1]
