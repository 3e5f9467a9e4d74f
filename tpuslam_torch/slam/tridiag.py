"""Super-block tridiagonal solver for banded H.

Port of ``tpuslam/slam/tridiag.py`` without the partitioned (SPIKE)
variant.  The block-banded matrix is re-tiled into a block-TRIDIAGONAL
system of dense super-blocks of ``S`` poses (``3S x 3S`` scalars,
``S >= band``), so the whole band fits in a diagonal block and one
coupling block, and block-Thomas elimination solves it in ``T1 / S``
sequential steps of dense ``3S x 3S`` algebra.

The chain runs as eager torch: one Python step a super-block, each a few
cuBLAS products, a cuSOLVER Cholesky and a triangular solve.  Nothing in
it reads the device, so the host enqueues the whole chain without a
synchronisation.  Its arithmetic is the reference's, in the reference's
order: ``w = inv_prev @ u_prev``, ``s = a - u_prev^T w``, ``0.5 (s +
s^T)``, Cholesky, the triangular inverse ``li``, ``inv = li^T li``; the
right-hand sides ride as ``(K, m)`` rows.  :func:`block_thomas_solve` is
:func:`block_thomas_factor` followed by :func:`block_thomas_substitute`,
so the staged solve equals the one-shot solve bit for bit, as in the
reference.

A matrix that is not positive definite: JAX's Cholesky returns NaN, and
``torch.linalg.cholesky`` would raise, which reads the device.
``torch.linalg.cholesky_ex`` does not check; where its ``info`` is not 0
the factor is set to NaN on the device, so "a NaN factor means the
prescaled system lost PD-ness" holds here too, with no synchronisation.

The flat path (:func:`banded_solve_tridiag_flat` and the factor/resolve
pair) takes the ``((band+1)*9, T1)`` storage of ``large.py``.  The JAX
package builds its dense super-blocks with one-hot matmuls and its row
interleave with one-hot einsums, which exist only to keep TPU layouts
unpadded; here both are index gathers and reshapes, which place the same
scalars exactly.
"""

from __future__ import annotations

import functools
import typing

import torch

from tpuslam_torch.core.precision import highest_matmul_precision


def band_to_tridiag(h_band, super_size: int):
    """Re-tile block-banded storage into super-block tridiagonal form.

    Args:
        h_band: ``(D, T1, 3, 3)`` upper-band storage (``D - 1 <= S``).
        super_size: S, 3x3 blocks per super-block; T1 must be a multiple
            of S (pad the trajectory if needed).

    Returns:
        ``(diag (N, 3S, 3S), upper (N-1, 3S, 3S))`` where N = T1 // S;
        ``upper[k] = H[super k, super k+1]``.
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    band = d1 - 1
    if band > super_size:
        raise ValueError(f"band {band} exceeds super block size "
                         f"{super_size}")
    if t1 % super_size:
        raise ValueError(f"T1 {t1} not a multiple of {super_size}")
    n = t1 // super_size
    s3 = 3 * super_size
    dev = h_band.device

    # wide[k, r, c] = H[k*S + r, k*S + c] for c in [0, S + band): block
    # (r, d) of each super-block goes to column c = r + d.  Each (r, c)
    # is written once, so a plain indexed assignment places it.
    r = torch.arange(super_size, device=dev)
    cols = r[:, None] + torch.arange(d1, device=dev)[None, :]
    hb = h_band.transpose(0, 1).reshape(n, super_size, d1, 3, 3)
    wide = h_band.new_zeros((n, super_size, super_size + band, 3, 3))
    wide[:, r[:, None], cols] = hb

    diag_u = wide[:, :, :super_size]
    upper = wide[:, :, super_size:]

    def to_dense(x):  # (n, S, C, 3, 3) -> (n, 3S, 3C)
        nn, ss, cc = x.shape[0], x.shape[1], x.shape[2]
        return x.permute(0, 1, 3, 2, 4).reshape(nn, 3 * ss, 3 * cc)

    # Mirror the strictly-upper BLOCKS (the (r, r) blocks are already
    # whole 3x3 matrices).
    strict = r[:, None] < r[None, :]
    diag = (to_dense(diag_u)
            + to_dense(diag_u * strict[None, :, :, None, None]).mT)
    up_d = to_dense(upper)  # (n, 3S, 3*band) -> embedded in (n, 3S, 3S)
    up = h_band.new_zeros((n, s3, s3))
    up[:, :, :up_d.shape[2]] = up_d
    return diag, up[:-1]


class ThomasFactor(typing.NamedTuple):
    """Reusable block-Thomas factorization (see :func:`block_thomas_factor`).

    ``invs[k] = S_k^{-1}`` (Schur-complement inverses), ``ws[k] =
    S_{k-1}^{-1} U_{k-1}`` (the forward-substitution multipliers), and
    ``up`` the zero-extended upper coupling blocks.
    """

    invs: torch.Tensor  # (N, M, M)
    ws: torch.Tensor  # (N, M, M)
    up: torch.Tensor  # (N, M, M)


@highest_matmul_precision
def block_thomas_factor(diag, upper) -> ThomasFactor:
    """Factor the symmetric block-tridiagonal system once (the
    rhs-independent half of :func:`block_thomas_solve`: the
    Cholesky/Schur recursion, O(M^3) a block).

    ``block_thomas_substitute(block_thomas_factor(d, u), b)`` is
    :func:`block_thomas_solve`, bit for bit.
    """
    n, m = diag.shape[0], diag.shape[1]
    up = torch.cat([upper, diag.new_zeros((1, m, m))], dim=0)
    eye = torch.eye(m, dtype=diag.dtype, device=diag.device)
    invs = torch.empty_like(diag)
    ws = torch.empty_like(diag)
    inv_prev, u_prev = eye, diag.new_zeros((m, m))
    for k in range(n):
        w = torch.matmul(inv_prev, u_prev, out=ws[k])  # S_{k-1}^-1 U_{k-1}
        s = diag[k] - u_prev.mT @ w
        s = 0.5 * (s + s.mT)
        chol, info = torch.linalg.cholesky_ex(s)
        # JAX's Cholesky gives NaN for a matrix that is not PD.
        chol = chol.masked_fill(info != 0, float("nan"))
        li = torch.linalg.solve_triangular(chol, eye, upper=False)
        inv_prev = torch.matmul(li.mT, li, out=invs[k])  # S_k^-1
        u_prev = up[k]
    return ThomasFactor(invs=invs, ws=ws, up=up)


@highest_matmul_precision
def block_thomas_substitute(factor: ThomasFactor, b):
    """Solve with a precomputed :class:`ThomasFactor` (two O(M^2)
    passes): the forward pass replays ``y_k = b_k - y_{k-1} W_k``, the
    backward pass is ``x_k = (y_k - x_{k+1} U_k^T) S_k^{-1}``.

    ``b`` is ``(N, M)``, or ``(N, K, M)`` for K right-hand sides.
    """
    invs, ws, up = factor
    n, m = invs.shape[0], invs.shape[1]
    squeeze = b.ndim == 2
    b_row = b[:, None, :] if squeeze else b  # (n, K, m)
    n_rhs = b_row.shape[1]
    ys = torch.empty_like(b_row)
    y_prev = b.new_zeros((n_rhs, m))
    for k in range(n):
        y_prev = torch.sub(b_row[k], y_prev @ ws[k], out=ys[k])
    xs = torch.empty_like(b_row)
    x_next = b.new_zeros((n_rhs, m))
    for k in range(n - 1, -1, -1):
        # x = S^-1 (y - U x_next); S^-1 is symmetric, so the row form is
        # (y_row - x_next_row U^T) S^-1.
        x_next = torch.matmul(ys[k] - x_next @ up[k].mT, invs[k],
                              out=xs[k])
    return xs[:, 0, :] if squeeze else xs


def block_thomas_solve(diag, upper, b):
    """Solve the symmetric block-tridiagonal system
    ``diag[k] x_k + upper[k] x_{k+1} + upper[k-1]^T x_{k-1} = b_k`` by
    block Thomas: Cholesky of each Schur complement with its explicit
    inverse carried forward, then back substitution.

    Args:
        diag: ``(N, M, M)``; upper: ``(N-1, M, M)``; b: ``(N, M)`` or
            ``(N, K, M)`` (row convention: row r of block k is rhs r's
            block-k segment).

    Returns:
        ``(N, M)`` (or ``(N, K, M)``) solution.
    """
    return block_thomas_substitute(block_thomas_factor(diag, upper), b)


def pad_band(h_band, b, multiple: int):
    """Pad the trajectory axis to a multiple with decoupled identity
    blocks (their solution is exactly 0 for the zero rhs padding)."""
    d1, t1 = h_band.shape[0], h_band.shape[1]
    pad = (-t1) % multiple
    if pad:
        tail = h_band.new_zeros((d1, pad, 3, 3))
        tail[0] = torch.eye(3, dtype=h_band.dtype, device=h_band.device)
        h_band = torch.cat([h_band, tail], dim=1)
        b = torch.cat([b, b.new_zeros((pad, 3))], dim=0)
    return h_band, b


def jacobi_prescale(h_band, b):
    """Symmetric Jacobi scaling s_i = 1/sqrt(H_ii) per scalar row (the
    1e4 gauge anchor otherwise pushes the float32 Schur recursion out of
    PD range).  Returns ``(h_scaled, b_scaled, s)``; un-scale a solution
    with ``x * s``."""
    d1, t1 = h_band.shape[0], h_band.shape[1]
    dev = h_band.device
    diag_scal = torch.diagonal(h_band[0], dim1=-2, dim2=-1)  # (T1, 3)
    s = torch.rsqrt(torch.clamp_min(diag_scal, 1e-30))
    # hb'[d, i, a, c] = hb * s[i, a] * s[i+d, c] (clamped at the end)
    idx = torch.clamp_max(torch.arange(t1, device=dev)[None, :]
                          + torch.arange(d1, device=dev)[:, None], t1 - 1)
    s_col = s[idx]  # (D, T1, 3)
    h_scaled = h_band * s[None, :, :, None] * s_col[:, :, None, :]
    return h_scaled, b * s, s


@highest_matmul_precision
def banded_solve_tridiag(h_band, b, super_size: int | None = None):
    """One-shot ``H x = b`` on ``(D, T1, 3, 3)`` storage, ``b`` ``(T1,
    3)``: pad to a super-block multiple, Jacobi-prescale, re-tile, block
    Thomas."""
    d1, t1 = h_band.shape[0], h_band.shape[1]
    band = d1 - 1
    if super_size is None:
        super_size = max(band, 1)
    h_band, b = pad_band(h_band, b, super_size)
    t_pad = h_band.shape[1]
    n = t_pad // super_size
    h_scaled, b_scaled, s = jacobi_prescale(h_band, b)
    diag, upper = band_to_tridiag(h_scaled, super_size)
    x = block_thomas_solve(diag, upper, b_scaled.reshape(n, 3 * super_size))
    return (x.reshape(t_pad, 3) * s)[:t1]


def _flat_prescale(h_flat, b_flat, band: int):
    """Flat-layout Jacobi prescale: s = 1/sqrt(diag), applied as row
    products (``h'[d*9+3a+b, i] = h * s[a, i] * s[b, i+d]``, the column
    index clamped at the end)."""
    d1 = band + 1
    t1 = h_flat.shape[1]
    dev = h_flat.device
    diag = torch.stack([h_flat[0], h_flat[4], h_flat[8]])  # (3, T1)
    s = torch.rsqrt(torch.clamp_min(diag, 1e-30))
    idx = torch.clamp_max(torch.arange(t1, device=dev)[None, :]
                          + torch.arange(d1, device=dev)[:, None], t1 - 1)
    s_shift = s[:, idx].transpose(0, 1)  # (D, 3, T1): s[b, i+d]
    scale = (s[None, :, None, :] * s_shift[:, None, :, :]).reshape(
        d1 * 9, t1)
    return h_flat * scale, b_flat * s, s


@functools.lru_cache(maxsize=16)
def _tridiag_slots(band: int, super_size: int, device: torch.device):
    """Where each scalar of a super-block's diagonal and upper coupling
    block comes from: ``(idx_diag, idx_upper)``, each ``(3S * 3S,)``
    indices into one super-block's ``(R * S + 1)`` flat entries (entry
    ``row * S + s`` is flat row ``row`` at the super-block's pose s,
    entry ``R * S`` a zero).

    Scalar row p = 3s + a of a super-block meets scalar column q on
    scalar diagonal o = q - p; its value is H[s, s + d][a, b] with
    3d + b = a + o, flat row d*9 + 3a + b, where d <= band.  As in the
    reference, the diagonal block takes only o >= 0 (the scalar upper
    triangle, completed by symmetry) and the coupling block every o.
    """
    s3 = 3 * super_size
    zero = (band + 1) * 9 * super_size
    p = torch.arange(s3)[:, None]
    q = torch.arange(s3)[None, :]
    s, a = p // 3, p % 3

    def slots(c, ok):
        d, b = c // 3, c % 3
        ok = ok & (d <= band)
        src = (d * 9 + 3 * a + b) * super_size + s
        return torch.where(ok, src, zero).reshape(-1).to(device)

    c_diag = q - 3 * s  # = a + o
    return (slots(c_diag, q >= p), slots(c_diag + s3, q >= 0))


def _flat_to_tridiag(h_flat, band: int, super_size: int,
                     drop_last: bool = True):
    """Super-block densification straight from flat banded storage:
    ``(diag (N, 3S, 3S), upper)`` with ``upper`` ``(N-1, 3S, 3S)``, or
    ``(N, ...)`` with ``drop_last=False`` (the last one couples to the
    block after this storage: zero for a whole matrix)."""
    if band > super_size:
        raise ValueError(f"band {band} exceeds super block size "
                         f"{super_size}")
    rows = (band + 1) * 9
    t1 = h_flat.shape[1]
    n = t1 // super_size
    s3 = 3 * super_size
    idx_diag, idx_upper = _tridiag_slots(band, super_size, h_flat.device)
    src = torch.cat([
        h_flat.reshape(rows, n, super_size).transpose(0, 1).reshape(
            n, rows * super_size),
        h_flat.new_zeros((n, 1))], dim=1)
    diag_u = src[:, idx_diag].reshape(n, s3, s3)
    upper = src[:, idx_upper].reshape(n, s3, s3)
    # Scalar-symmetric completion of the diagonal blocks.
    diag = diag_u + torch.triu(diag_u, 1).mT
    return diag, (upper[:-1] if drop_last else upper)


def pad_flat(h_flat, b_flat, multiple: int):
    """Flat-layout twin of :func:`pad_band`: pad the trajectory axis to a
    multiple with decoupled identity scalar blocks."""
    t1 = h_flat.shape[1]
    pad = (-t1) % multiple
    if pad:
        h_flat = torch.nn.functional.pad(h_flat, (0, pad))
        h_flat[[0, 4, 8], t1:] = 1.0
        b_flat = torch.nn.functional.pad(b_flat, (0, pad))
    return h_flat, b_flat


def flat_rows_to_super(b_s, super_size: int):
    """Interleave ``(3, T1)`` phase rows into ``(N, 3S)`` scalar order
    (scalar p = 3s + a of super-block k is ``b_s[a, k*S + s]``)."""
    n = b_s.shape[1] // super_size
    return b_s.reshape(3, n, super_size).permute(1, 2, 0).reshape(
        n, 3 * super_size)


def super_rows_to_flat(x, super_size: int):
    """Inverse of :func:`flat_rows_to_super`: ``(N, 3S)`` -> ``(3, T1)``."""
    n = x.shape[0]
    return x.reshape(n, super_size, 3).permute(2, 0, 1).reshape(
        3, n * super_size)


class TridiagFlatFactor(typing.NamedTuple):
    """Reusable factorization of a flat banded system (prescale + Thomas
    factor); solve new right-hand sides with
    :func:`banded_resolve_tridiag_flat`."""

    factor: ThomasFactor
    s: torch.Tensor  # (3, T_pad) Jacobi prescale rows


def _no_parts(n_parts) -> None:
    if n_parts is not None:
        raise NotImplementedError(
            "n_parts (the partitioned Thomas factor) is not ported yet: "
            "ROADMAP.md section 1, item 4 (the other banded solvers)")


@highest_matmul_precision
def banded_factor_tridiag_flat(h_flat, band: int,
                               super_size: int | None = None,
                               n_parts: int | None = None
                               ) -> TridiagFlatFactor:
    """Factor a flat banded system once for many right-hand sides: pad,
    Jacobi prescale, super-block densification and
    :func:`block_thomas_factor`.  ``n_parts`` raises
    ``NotImplementedError``."""
    _no_parts(n_parts)
    if super_size is None:
        super_size = max(band, 1)
    zeros = h_flat.new_zeros((3, h_flat.shape[1]))
    h_flat, b_pad = pad_flat(h_flat, zeros, super_size)
    h_s, _, s = _flat_prescale(h_flat, b_pad, band)
    diag, upper = _flat_to_tridiag(h_s, band, super_size)
    return TridiagFlatFactor(factor=block_thomas_factor(diag, upper), s=s)


@highest_matmul_precision
def banded_resolve_tridiag_flat(fac: TridiagFlatFactor, b_flat,
                                super_size: int) -> torch.Tensor:
    """Solve ``H x = b`` with a precomputed :class:`TridiagFlatFactor`;
    ``b_flat`` is ``(3, T1)``, the result ``(T1, 3)``."""
    t1 = b_flat.shape[1]
    t_pad = fac.s.shape[1]
    b_flat = torch.nn.functional.pad(b_flat, (0, t_pad - t1))
    b_sup = flat_rows_to_super(b_flat * fac.s, super_size)
    x = block_thomas_substitute(fac.factor, b_sup)
    x3 = super_rows_to_flat(x, super_size) * fac.s
    return x3.T[:t1]


def banded_solve_tridiag_flat(h_flat, b_flat, band: int,
                              super_size: int | None = None):
    """Flat-layout twin of :func:`banded_solve_tridiag`: ``h_flat``
    ``((band+1)*9, T1)``, ``b_flat`` ``(3, T1)``, result ``(T1, 3)``.
    The factor then the resolve, so it equals
    :func:`banded_resolve_tridiag_flat` of
    :func:`banded_factor_tridiag_flat` bit for bit."""
    if super_size is None:
        super_size = max(band, 1)
    fac = banded_factor_tridiag_flat(h_flat, band, super_size)
    return banded_resolve_tridiag_flat(fac, b_flat, super_size)
