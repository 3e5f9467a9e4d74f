"""Blocked banded Cholesky: the exact direct solver for the graph system.

Port of ``tpuslam/slam/cholesky.py``.  The block-banded information
matrix H (``hb[d, i] = H[i, i+d]``, d in [0, band]) is factored as L L^T
with L in the same lower-band structure, then solved by forward and
backward substitution: O(T band^2) 3x3-block operations, each step's
algebra vectorised over the band.

The reference's scans become Python loops of ``T1`` steps that carry a
window of the last ``band`` factor columns, ``(band, D, 3, 3)``; the
window's gathers take index tensors made once, outside the loop.
Nothing in a loop reads the device.  On a card each step is a few dozen
small launches, so the solve is bound by the host's launch rate.

The 3x3 helpers are this module's own: :func:`_chol3` clamps each pivot
at 1e-30 (``tridiag``'s reference twin does not), and
:func:`_inv_lower3` keeps the reference module's order of products.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.precision import highest_matmul_precision


def _chol3(a):
    """Closed-form Cholesky of ``(..., 3, 3)`` SPD blocks, each pivot
    clamped at 1e-30."""
    eps = 1e-30
    l00 = torch.sqrt(torch.clamp_min(a[..., 0, 0], eps))
    l10 = a[..., 1, 0] / l00
    l20 = a[..., 2, 0] / l00
    l11 = torch.sqrt(torch.clamp_min(a[..., 1, 1] - l10 * l10, eps))
    l21 = (a[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp_min(a[..., 2, 2] - l20 * l20 - l21 * l21,
                                     eps))
    z = torch.zeros_like(l00)
    return torch.stack([
        torch.stack([l00, z, z], dim=-1),
        torch.stack([l10, l11, z], dim=-1),
        torch.stack([l20, l21, l22], dim=-1),
    ], dim=-2)


def _inv_lower3(lo):
    """Inverse of ``(..., 3, 3)`` lower-triangular blocks, closed form."""
    i00 = 1.0 / lo[..., 0, 0]
    i11 = 1.0 / lo[..., 1, 1]
    i22 = 1.0 / lo[..., 2, 2]
    i10 = -lo[..., 1, 0] * i00 * i11
    i20 = (lo[..., 1, 0] * lo[..., 2, 1] - lo[..., 2, 0] * lo[..., 1, 1]) * (
        i00 * i11 * i22)
    i21 = -lo[..., 2, 1] * i11 * i22
    z = torch.zeros_like(i00)
    return torch.stack([
        torch.stack([i00, z, z], dim=-1),
        torch.stack([i10, i11, z], dim=-1),
        torch.stack([i20, i21, i22], dim=-1),
    ], dim=-2)


def _window_index(band: int, dtype, device):
    """The carried window's gathers: ``a_idx`` (band,), and ``g_idx``
    (D, band) with its validity mask ``g_ok`` (D, band, 1, 1): window
    entry ``C[a, d + a + 1]`` is ``L[i+d, i-1-a]``, 0 past the band."""
    a_idx = torch.arange(band, device=device)
    d_idx = torch.arange(band + 1, device=device)
    raw = d_idx[:, None] + a_idx[None, :] + 1
    g_ok = (raw <= band).to(dtype)[..., None, None]
    return a_idx, torch.clamp(raw, 0, band), g_ok


def _factor_step(c, h_col, a_idx, g_idx, g_ok):
    """One column of the factor: ``c`` the window ``(band, D, 3, 3)`` of
    columns i-1, i-2, ...; ``h_col[d] = H[i+d, i]``.  Returns ``(col,
    cd, l00_inv)``: ``col[d] = L[i+d, i]``, ``cd[a] = L[i, i-1-a]``."""
    cd = c[a_idx, a_idx + 1]
    s = h_col[0] - torch.einsum("aij,akj->ik", cd, cd)
    l00 = _chol3(s)
    l00_inv = _inv_lower3(l00)
    g = c[a_idx[None, :], g_idx] * g_ok  # (D, band, 3, 3)
    m = h_col - torch.einsum("daij,akj->dik", g, cd)
    col = m @ l00_inv.mT
    col[0] = l00
    return col, cd, l00_inv


def _shift_in(win, new):
    """The window with ``new`` in front and its oldest entry dropped."""
    return torch.cat([new[None], win[:-1]], dim=0)


@highest_matmul_precision
def banded_cholesky(hb):
    """Factor block-banded SPD H into lower-banded L (the same storage).

    Args:
        hb: ``(D, T1, 3, 3)`` upper-band storage, ``hb[d, i] = H[i,
            i+d]``.

    Returns:
        ``lb``: ``(D, T1, 3, 3)`` lower-band storage, ``lb[d, i] =
        L[i+d, i]`` (block column i of the factor).
    """
    d1, t1 = hb.shape[0], hb.shape[1]
    band = d1 - 1
    hb_cols = hb.transpose(0, 1).mT  # hb_cols[i, d] = H[i+d, i]
    idx = _window_index(band, hb.dtype, hb.device)
    c = hb.new_zeros((band, d1, 3, 3))
    cols = hb.new_empty((t1, d1, 3, 3))
    for i in range(t1):
        col = _factor_step(c, hb_cols[i], *idx)[0]
        cols[i] = col
        c = _shift_in(c, col)
    return cols.transpose(0, 1)


@highest_matmul_precision
def banded_chol_solve(lb, b):
    """Solve ``H x = b`` given the banded factor of
    :func:`banded_cholesky`: forward substitution ``L z = b``, then
    backward ``L^T x = z``, each with a ``band``-deep window."""
    d1, t1 = lb.shape[0], lb.shape[1]
    band = d1 - 1
    dev = lb.device
    l00_inv = _inv_lower3(lb[0])  # (T1, 3, 3)

    # lsh[i, d-1] = L[i, i-d] = lb[d, i-d] for d in [1, band], 0 before
    # the start.
    d_idx = torch.arange(1, d1, device=dev)
    i_idx = torch.arange(t1, device=dev)
    raw = i_idx[:, None] - d_idx[None, :]
    ok = (raw >= 0).to(lb.dtype)[..., None, None]
    lsh = lb[d_idx[None, :], torch.clamp(raw, 0, t1 - 1)] * ok

    z = b.new_empty((t1, 3))
    win = b.new_zeros((band, 3))  # win[a] = z[i-1-a]
    for i in range(t1):
        zi = l00_inv[i] @ (b[i] - torch.einsum("aij,aj->i", lsh[i], win))
        z[i] = zi
        win = _shift_in(win, zi)

    # x[i] = inv(L00_i^T) (z[i] - sum_d lb[d, i]^T x[i+d]).
    lb_t = lb.transpose(0, 1).mT  # (T1, D, 3, 3)
    x = b.new_empty((t1, 3))
    win = b.new_zeros((band, 3))  # win[a] = x[i+1+a]
    for i in range(t1 - 1, -1, -1):
        xi = l00_inv[i].mT @ (z[i] - torch.einsum("aij,aj->i", lb_t[i, 1:],
                                                   win))
        x[i] = xi
        win = _shift_in(win, xi)
    return x


def banded_solve_direct(hb, b):
    """One-shot ``H x = b`` by banded Cholesky (the factor, then both
    substitutions)."""
    return banded_chol_solve(banded_cholesky(hb),
                             b.reshape(-1, 3)).reshape(b.shape)


@highest_matmul_precision
def banded_solve_direct_flat(h_flat, b_flat, band: int):
    """Flat-layout twin of :func:`banded_solve_direct`: the same 3x3
    block recursions, H read a time's row at a time from
    ``((band+1)*9, T1)`` storage, the forward substitution folded into
    the factor's loop (its window holds the columns it needs) and the
    backward one over the emitted factor rows.

    Args:
        h_flat: ``((band+1)*9, T1)``, ``h_flat[d*9 + 3a + b, t] = H[t,
            t+d][a, b]``.
        b_flat: ``(3, T1)`` phase-major right-hand side.

    Returns:
        ``(T1, 3)`` solution.
    """
    d1 = band + 1
    t1 = h_flat.shape[1]
    idx = _window_index(band, h_flat.dtype, h_flat.device)
    ht = h_flat.T  # (T1, D*9)
    bt = b_flat.T  # (T1, 3)

    c = h_flat.new_zeros((band, d1, 3, 3))
    zwin = h_flat.new_zeros((band, 3))
    lrows = h_flat.new_empty((t1, d1, 3, 3))
    z = h_flat.new_empty((t1, 3))
    for i in range(t1):
        # h_col[d] = H[i+d, i] = (flat block d at column i)^T.
        h_col = ht[i].reshape(d1, 3, 3).mT
        col, cd, l00_inv = _factor_step(c, h_col, *idx)
        z_i = l00_inv @ (bt[i] - torch.einsum("aij,aj->i", cd, zwin))
        lrows[i] = col
        z[i] = z_i
        c = _shift_in(c, col)
        zwin = _shift_in(zwin, z_i)

    x = h_flat.new_empty((t1, 3))
    xwin = h_flat.new_zeros((band, 3))  # xwin[a] = x[i+1+a]
    for i in range(t1 - 1, -1, -1):
        col = lrows[i]
        xi = _inv_lower3(col[0]).mT @ (
            z[i] - torch.einsum("aji,aj->i", col[1:], xwin))
        x[i] = xi
        xwin = _shift_in(xwin, xi)
    return x
