"""Super-block tridiagonal solver for banded H.

Port of ``tpuslam/slam/tridiag.py``.  The block-banded matrix is
re-tiled into a block-TRIDIAGONAL system of dense super-blocks of ``S``
poses (``3S x 3S`` scalars, ``S >= band``), so the whole band fits in a
diagonal block and one coupling block, and block-Thomas elimination
solves it in ``T1 / S`` sequential steps of dense ``3S x 3S`` algebra.

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

The partitioned factor (:func:`block_thomas_factor_partitioned`, the
reference's single-chip SPIKE variant) cuts the chain into ``C`` chunks:
three batched chains of depth ``N / C`` over the chunks and one reduced
chain of depth ``C`` over their interfaces, each step the same algebra
batched over ``C``.  The reference's ``inv_impl="blocked"`` (closed-form
3x3 panels that kept XLA:TPU's Cholesky from serialising over the batch,
measured slower there) is refused by name; the batched inverse is
cuSOLVER's batched Cholesky and cuBLAS's batched triangular solve.

A matrix that is not positive definite: JAX's Cholesky returns NaN, and
``torch.linalg.cholesky`` would raise, which reads the device.
``torch.linalg.cholesky_ex`` does not check; where its ``info`` is not 0
the factor is set to NaN on the device, so "a NaN factor means the
prescaled system lost PD-ness" holds here too, with no synchronisation.
In a batch, only the matrices whose ``info`` is not 0 become NaN.

The factor and its substitution take batch axes after the chain axis,
``(N, *B, M, M)``: each step is then one batched Cholesky, triangular
solve and product over the batch, so S scenes' chains cost the launches
of one.  The flat path (:func:`banded_solve_tridiag_flat` and the
factor/resolve pair) takes the ``((band+1)*9, T1)`` storage of
``large.py``, and the pair a leading scene axis, ``(S, (band+1)*9, T1)``.
On a CUDA card :func:`factor_resolver` replays a scene-axis factor and
its resolves as CUDA graphs: the chain is 250 steps of about 35 launches
at BASELINE config 5's size, which the host otherwise issues one by one,
slower than the card runs them.  The JAX
package builds its dense super-blocks with one-hot matmuls and its row
interleave with one-hot einsums, which exist only to keep TPU layouts
unpadded; here both are index gathers and reshapes, which place the same
scalars exactly.
"""

from __future__ import annotations

import collections
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


def cholesky_nan(a):
    """Lower Cholesky factor of ``a`` (``(..., M, M)``), unchecked: the
    matrices that are not positive definite get a NaN factor, as JAX's
    Cholesky gives them, with no host read."""
    chol, info = torch.linalg.cholesky_ex(a)
    return chol.masked_fill((info != 0)[..., None, None], float("nan"))


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

    ``diag`` is ``(N, *B, M, M)`` and ``upper`` ``(N-1, *B, M, M)``: the
    chain axis first, then any batch axes, each step batched over them.
    ``block_thomas_substitute(block_thomas_factor(d, u), b)`` is
    :func:`block_thomas_solve`, bit for bit.
    """
    n, m = diag.shape[0], diag.shape[-1]
    batch = diag.shape[1:-2]
    up = torch.cat([upper, diag.new_zeros((1, *batch, m, m))], dim=0)
    eye = torch.eye(m, dtype=diag.dtype, device=diag.device)
    invs = torch.empty_like(diag)
    ws = torch.empty_like(diag)
    inv_prev, u_prev = eye, diag.new_zeros((*batch, m, m))
    for k in range(n):
        w = torch.matmul(inv_prev, u_prev, out=ws[k])  # S_{k-1}^-1 U_{k-1}
        s = diag[k] - u_prev.mT @ w
        s = 0.5 * (s + s.mT)
        li = torch.linalg.solve_triangular(cholesky_nan(s), eye, upper=False)
        inv_prev = torch.matmul(li.mT, li, out=invs[k])  # S_k^-1
        u_prev = up[k]
    return ThomasFactor(invs=invs, ws=ws, up=up)


@highest_matmul_precision
def block_thomas_substitute(factor: ThomasFactor, b):
    """Solve with a precomputed :class:`ThomasFactor` (two O(M^2)
    passes): the forward pass replays ``y_k = b_k - y_{k-1} W_k``, the
    backward pass is ``x_k = (y_k - x_{k+1} U_k^T) S_k^{-1}``.

    ``b`` is ``(N, *B, M)``, or ``(N, *B, K, M)`` for K right-hand sides,
    with the factor's batch axes B.
    """
    invs, ws, up = factor
    n = invs.shape[0]
    squeeze = b.ndim == invs.ndim - 1
    b_row = b.unsqueeze(-2) if squeeze else b  # (n, *B, K, m)
    ys = torch.empty_like(b_row)
    y_prev = b.new_zeros(b_row.shape[1:])
    for k in range(n):
        y_prev = torch.sub(b_row[k], y_prev @ ws[k], out=ys[k])
    xs = torch.empty_like(b_row)
    x_next = b.new_zeros(b_row.shape[1:])
    for k in range(n - 1, -1, -1):
        # x = S^-1 (y - U x_next); S^-1 is symmetric, so the row form is
        # (y_row - x_next_row U^T) S^-1.
        x_next = torch.matmul(ys[k] - x_next @ up[k].mT, invs[k],
                              out=xs[k])
    return xs.squeeze(-2) if squeeze else xs


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


class PartitionedThomasFactor(typing.NamedTuple):
    """Partitioned (SPIKE-style) block-Thomas factor of ``C`` chunks of
    ``m`` blocks (see :func:`block_thomas_factor_partitioned`).

    ``chunk``'s fields are time-major, ``(m-1, C, M, M)``: the chunks'
    interior factors.  ``red`` is the reduced interface system's factor
    (C blocks); ``b_cpl[c]`` couples chunk c's last interior block to its
    interface, ``c_cpl[c]`` the interface to chunk c+1 (zero for the
    last chunk).
    """

    chunk: ThomasFactor
    red: ThomasFactor
    b_cpl: torch.Tensor  # (C, M, M)
    c_cpl: torch.Tensor  # (C, M, M)


def _batched_inv_spd(a):
    """Batched SPD inverse by Cholesky (the Thomas factor's per-step
    chain: symmetrise, Cholesky, triangular inverse ``li``, ``li^T
    li``)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol = cholesky_nan(0.5 * (a + a.mT))
    li = torch.linalg.solve_triangular(chol, eye.expand(a.shape),
                                       upper=False)
    return li.mT @ li


def _rowmat(rows, mats):
    """Batched row vector times matrix: ``(C, M) @ (C, M, M) -> (C,
    M)``."""
    return (rows.unsqueeze(-2) @ mats).squeeze(-2)


@highest_matmul_precision
def block_thomas_factor_partitioned(diag, upper, n_parts: int,
                                    inv_impl: str = "lax"
                                    ) -> PartitionedThomasFactor:
    """Factor the N-block chain as ``n_parts`` chunks of ``m = N /
    n_parts >= 2`` blocks (the chunks' interiors ``u_c``, each chunk's
    last block ``s_c`` its interface; ``B_c`` couples interior m-2 to
    ``s_c``, ``C_c`` couples ``s_c`` to chunk c+1's interior 0):

      Ahat_c = A_sc - B_c^T Dm_c B_c - C_c D0_{c+1} C_c^T
      Uhat_c = -C_c G_{c+1} B_{c+1}

    with ``Dm = [T^-1]_{m-2,m-2}`` (the chunk factor's last Schur
    inverse), ``D0 = [T^-1]_{0,0}`` (a reverse Schur recursion) and ``G
    = [T^-1]_{0,m-2}`` (the backward chain ``x_j = -inv_j U_j
    x_{j+1}``).  Each of the three chains has depth m-1 or m-2 and is
    batched over the chunks; the reduced system is a sequential
    :func:`block_thomas_factor` of C blocks.

    ``inv_impl`` must be ``"lax"`` (the reference's default and only
    portable form); ``"blocked"`` and any other name raise
    ``ValueError``.
    """
    if inv_impl == "blocked":
        raise ValueError(
            "inv_impl='blocked' is an XLA:TPU layout workaround that "
            "measured slower there and is not ported; use 'lax'")
    if inv_impl != "lax":
        raise ValueError(f"unknown inv_impl {inv_impl!r}: 'lax'")
    n, m_blk = diag.shape[0], diag.shape[1]
    c = n_parts
    if n % c:
        raise ValueError(f"N={n} not a multiple of n_parts={c}")
    m = n // c
    if m < 2:
        raise ValueError(f"n_parts={c} leaves m={m} < 2 blocks/chunk")
    zero = diag.new_zeros((1, m_blk, m_blk))
    up_r = torch.cat([upper, zero], dim=0).reshape(c, m, m_blk, m_blk)
    diag_r = diag.reshape(c, m, m_blk, m_blk)
    # Time-major interiors: every chain below steps the within-chunk
    # axis with the chunks as its batch.
    a_int = diag_r[:, :m - 1].transpose(0, 1)
    a_if = diag_r[:, m - 1]  # (C, M, M) interface diagonals
    u_int = up_r[:, :m - 2].transpose(0, 1)  # (m-2, C, M, M)
    b_cpl = up_r[:, m - 2]
    c_cpl = up_r[:, m - 1]  # zero for the last chunk

    # The chunks' factors: the Thomas chain batched over the chunks.
    chunk = block_thomas_factor(a_int, u_int)
    invs = chunk.invs
    dm = invs[-1]  # [T^-1]_{m-2,m-2}

    # D0 = [T^-1]_{0,0} by the reverse Schur recursion (carry only).
    s0 = a_int[-1]
    for j in range(m - 3, -1, -1):
        s0 = a_int[j] - u_int[j] @ _batched_inv_spd(s0) @ u_int[j].mT
        s0 = 0.5 * (s0 + s0.mT)
    d0 = _batched_inv_spd(s0)

    # G = [T^-1]_{0,m-2} by x_j = -inv_j U_j x_{j+1}, x_{m-2} = Dm.
    g_cor = dm
    for j in range(m - 3, -1, -1):
        g_cor = -(invs[j] @ (u_int[j] @ g_cor))

    # Chunk C-1's d0_next is chunk 0's, finite and multiplied by its
    # zero c_cpl.
    d0_next = torch.roll(d0, -1, dims=0)
    ahat = (a_if - b_cpl.mT @ dm @ b_cpl
            - c_cpl @ d0_next @ c_cpl.mT)
    ahat = 0.5 * (ahat + ahat.mT)
    uhat = -(c_cpl[:-1] @ g_cor[1:] @ b_cpl[1:])
    return PartitionedThomasFactor(
        chunk=chunk,
        red=block_thomas_factor(ahat, uhat), b_cpl=b_cpl, c_cpl=c_cpl)


@highest_matmul_precision
def block_thomas_substitute_partitioned(fac: PartitionedThomasFactor, b):
    """Solve with a :class:`PartitionedThomasFactor`: two batched chunk
    substitutions (depth m-1) around the reduced solve (depth C).  ``b``
    is ``(N, M)`` rows; returns ``(N, M)``."""
    c = fac.b_cpl.shape[0]
    m = fac.chunk.invs.shape[0] + 1
    m_blk = b.shape[-1]
    g = b.reshape(c, m, m_blk)
    g_int = g[:, :m - 1].transpose(0, 1)  # (m-1, C, M)
    r = block_thomas_substitute(fac.chunk, g_int)
    # bhat_c = f_c - r_c[m-2] B_c - r_{c+1}[0] C_c^T (the row forms of
    # B^T x and C x); chunk C-1's r_next0 is chunk 0's, times its zero
    # c_cpl.
    r_next0 = torch.roll(r[0], -1, dims=0)
    bhat = (g[:, m - 1] - _rowmat(r[m - 2], fac.b_cpl)
            - _rowmat(r_next0, fac.c_cpl.mT))
    s = block_thomas_substitute(fac.red, bhat)  # (C, M)
    # g' = g - e_{m-2} B_c s_c - e_0 C_{c-1}^T s_{c-1}; chunk 0 has no
    # left neighbour.
    corr_last = _rowmat(s, fac.b_cpl.mT)
    corr_first = _rowmat(torch.roll(s, 1, dims=0),
                         torch.roll(fac.c_cpl, 1, dims=0))
    corr_first[0] = 0.0
    g2 = g_int.clone()
    g2[m - 2] += -corr_last
    g2[0] += -corr_first
    u = block_thomas_substitute(fac.chunk, g2)
    x = torch.cat([u.transpose(0, 1), s[:, None]], dim=1)  # (C, m, M)
    return x.reshape(c * m, m_blk)


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
    index clamped at the end).  Leading scene axes ride along."""
    d1 = band + 1
    t1 = h_flat.shape[-1]
    dev = h_flat.device
    diag = torch.stack([h_flat[..., 0, :], h_flat[..., 4, :],
                        h_flat[..., 8, :]], dim=-2)  # (..., 3, T1)
    s = torch.rsqrt(torch.clamp_min(diag, 1e-30))
    idx = torch.clamp_max(torch.arange(t1, device=dev)[None, :]
                          + torch.arange(d1, device=dev)[:, None], t1 - 1)
    s_shift = s[..., idx].transpose(-3, -2)  # (..., D, 3, T1): s[b, i+d]
    scale = (s[..., None, :, None, :]
             * s_shift[..., :, None, :, :]).reshape(
        *h_flat.shape[:-2], d1 * 9, t1)
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
    block after this storage: zero for a whole matrix).  A leading scene
    axis, ``h_flat`` ``(B, rows, T1)``, comes out after the chain axis:
    ``(N, B, 3S, 3S)``."""
    if band > super_size:
        raise ValueError(f"band {band} exceeds super block size "
                         f"{super_size}")
    rows = (band + 1) * 9
    t1 = h_flat.shape[-1]
    batch = h_flat.shape[:-2]
    n = t1 // super_size
    s3 = 3 * super_size
    idx_diag, idx_upper = _tridiag_slots(band, super_size, h_flat.device)
    src = torch.cat([
        h_flat.reshape(*batch, rows, n, super_size).movedim(-2, 0).reshape(
            n, *batch, rows * super_size),
        h_flat.new_zeros((n, *batch, 1))], dim=-1)
    diag_u = src[..., idx_diag].reshape(n, *batch, s3, s3)
    upper = src[..., idx_upper].reshape(n, *batch, s3, s3)
    # Scalar-symmetric completion of the diagonal blocks.
    diag = diag_u + torch.triu(diag_u, 1).mT
    return diag, (upper[:-1] if drop_last else upper)


def pad_flat(h_flat, b_flat, multiple: int):
    """Flat-layout twin of :func:`pad_band`: pad the trajectory axis to a
    multiple with decoupled identity scalar blocks (leading scene axes
    ride along)."""
    t1 = h_flat.shape[-1]
    pad = (-t1) % multiple
    if pad:
        h_flat = torch.nn.functional.pad(h_flat, (0, pad))
        # Rows 0, 4 and 8 (the diagonal entries) by a strided slice: a
        # list index would copy it to the device and synchronise.
        h_flat[..., 0:9:4, t1:] = 1.0
        b_flat = torch.nn.functional.pad(b_flat, (0, pad))
    return h_flat, b_flat


def flat_rows_to_super(b_s, super_size: int):
    """Interleave ``(3, T1)`` phase rows into ``(N, 3S)`` scalar order
    (scalar p = 3s + a of super-block k is ``b_s[a, k*S + s]``); leading
    scene axes ``(*B, 3, T1)`` come out after the chain axis, ``(N, *B,
    3S)``."""
    batch = b_s.shape[:-2]
    n = b_s.shape[-1] // super_size
    return b_s.reshape(*batch, 3, n, super_size).movedim(-2, 0).transpose(
        -1, -2).reshape(n, *batch, 3 * super_size)


def super_rows_to_flat(x, super_size: int):
    """Inverse of :func:`flat_rows_to_super`: ``(N, *B, 3S)`` -> ``(*B,
    3, T1)``."""
    n, batch = x.shape[0], x.shape[1:-1]
    return x.reshape(n, *batch, super_size, 3).transpose(-1, -2).movedim(
        0, -2).reshape(*batch, 3, n * super_size)


class TridiagFlatFactor(typing.NamedTuple):
    """Reusable factorization of a flat banded system (prescale + Thomas
    factor, sequential or partitioned); solve new right-hand sides with
    :func:`banded_resolve_tridiag_flat`."""

    factor: ThomasFactor | PartitionedThomasFactor
    s: torch.Tensor  # (*B, 3, T_pad) Jacobi prescale rows


@highest_matmul_precision
def banded_factor_tridiag_flat(h_flat, band: int,
                               super_size: int | None = None,
                               n_parts: int | None = None
                               ) -> TridiagFlatFactor:
    """Factor a flat banded system once for many right-hand sides: pad,
    Jacobi prescale, super-block densification and
    :func:`block_thomas_factor`, or with ``n_parts``
    :func:`block_thomas_factor_partitioned` (the trajectory then padded
    to a ``super_size * n_parts`` multiple; the solution agrees with the
    sequential factor's to rounding, not bit for bit).  ``h_flat`` may
    carry a leading scene axis, ``(S, rows, T1)``, on the sequential
    factor only: its fields are then ``(N, S, M, M)``."""
    if super_size is None:
        super_size = max(band, 1)
    if n_parts and h_flat.ndim != 2:
        raise ValueError("n_parts (the partitioned factor) takes no scene "
                         "axis")
    quantum = super_size * n_parts if n_parts else super_size
    zeros = h_flat.new_zeros((*h_flat.shape[:-2], 3, h_flat.shape[-1]))
    h_flat, b_pad = pad_flat(h_flat, zeros, quantum)
    h_s, _, s = _flat_prescale(h_flat, b_pad, band)
    diag, upper = _flat_to_tridiag(h_s, band, super_size)
    if n_parts:
        fac = block_thomas_factor_partitioned(diag, upper, n_parts)
    else:
        fac = block_thomas_factor(diag, upper)
    return TridiagFlatFactor(factor=fac, s=s)


@highest_matmul_precision
def banded_resolve_tridiag_flat(fac: TridiagFlatFactor, b_flat,
                                super_size: int) -> torch.Tensor:
    """Solve ``H x = b`` with a precomputed :class:`TridiagFlatFactor`;
    ``b_flat`` is ``(3, T1)``, the result ``(T1, 3)``, or with the
    factor's scene axis ``(S, 3, T1)`` and ``(S, T1, 3)``."""
    t1 = b_flat.shape[-1]
    t_pad = fac.s.shape[-1]
    b_flat = torch.nn.functional.pad(b_flat, (0, t_pad - t1))
    b_sup = flat_rows_to_super(b_flat * fac.s, super_size)
    if isinstance(fac.factor, PartitionedThomasFactor):
        x = block_thomas_substitute_partitioned(fac.factor, b_sup)
    else:
        x = block_thomas_substitute(fac.factor, b_sup)
    x3 = super_rows_to_flat(x, super_size) * fac.s
    return x3.transpose(-1, -2)[..., :t1, :]


#: CUDA graphs of :func:`factor_resolver`, by the system's shape, dtype,
#: device, band and super-block size: the two used last are kept.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPHS_KEPT = 2


class _Graphs(typing.NamedTuple):
    """One shape's captured factor and resolve, with their static
    arguments and outputs; ``owner`` is the resolver whose factor the
    outputs hold."""

    h_in: torch.Tensor
    factor: torch.cuda.CUDAGraph
    b_in: torch.Tensor
    resolve: torch.cuda.CUDAGraph
    x_out: torch.Tensor
    owner: list


def _captured(fn, arg):
    """``(graph, output)``: a CUDA graph of ``fn(arg)``, captured after
    one run on the capture's own stream (which sets up cuBLAS and cuSOLVER
    there)."""
    dev = arg.device
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn(arg)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn(arg)
    return graph, out


def factor_resolver(h_flat, band: int, super_size: int,
                    n_parts: int | None = None):
    """:func:`banded_factor_tridiag_flat` of ``h_flat``, and a resolve
    ``b_flat -> x`` with it (:func:`banded_resolve_tridiag_flat`), for a
    solve that resolves one factor many times.

    With a scene axis on a CUDA card the factor and each resolve replay
    CUDA graphs, captured at the first call of the shape: the factor then
    lives in the graph's memory and serves one resolver, the one made
    last for the shape; an older one raises ``RuntimeError``.  Each
    resolve returns a tensor of its own.  Elsewhere both run eagerly."""
    if n_parts or h_flat.ndim == 2 or h_flat.device.type != "cuda":
        fac = banded_factor_tridiag_flat(h_flat, band, super_size, n_parts)
        return functools.partial(banded_resolve_tridiag_flat, fac,
                                 super_size=super_size)
    key = (h_flat.shape, h_flat.dtype, h_flat.device, band, super_size)
    g = _GRAPHS.pop(key, None)
    if g is None:
        h_in = h_flat.clone()
        factor, fac = _captured(functools.partial(
            banded_factor_tridiag_flat, band=band, super_size=super_size),
            h_in)
        b_in = h_flat.new_zeros((h_flat.shape[0], 3, h_flat.shape[-1]))
        resolve, x_out = _captured(functools.partial(
            banded_resolve_tridiag_flat, fac, super_size=super_size), b_in)
        g = _Graphs(h_in, factor, b_in, resolve, x_out, [None])
    _GRAPHS[key] = g
    while len(_GRAPHS) > _GRAPHS_KEPT:
        _GRAPHS.popitem(last=False)
    g.h_in.copy_(h_flat)
    g.factor.replay()

    def resolve(b_flat):
        if g.owner[0] is not resolve:
            raise RuntimeError("a later factor of this shape has replaced "
                               "this resolver's")
        g.b_in.copy_(b_flat)
        g.resolve.replay()
        return g.x_out.clone()

    g.owner[0] = resolve
    return resolve


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
