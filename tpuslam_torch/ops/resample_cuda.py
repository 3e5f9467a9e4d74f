"""The systematic merge resample: K3 as CUDA kernels and their plain
twins.

Port of ``tpuslam/ops/resample_pallas.py``.  :func:`merge_resample_rows`
resamples ``(3, n_pad)`` particle rows by their weights with the
selection of ``filters/pf.py::resample_indices(method="hist")``, bit for
bit, and copies the float32 values exactly.  Its form on the card is
prefix -> boundary -> slots -> copy (see ``csrc/resample.cu``):

* :func:`resample_boundary` (kernel, K3a, one cooperative launch): the
  weights' float total in a fixed order (:func:`boundary_total_plain`),
  their quantized integers of ``2^-20`` of it, the exact prefix and
  ``1 / q_tot``, the boundary law, the forcing ``t[n-1] = n``; no torch
  op runs before it;
* :func:`resample_expand` (kernel, K3b): each output slot's source
  particle and the copy of its values, a block a range of output slots;
* :func:`resample_expand_seg` (kernel, K3b in segments): the wide
  batched filter's pass B, each firing slot expanding its own filter, a
  block a window of staged boundaries.

The fused single filter resamples on its ESS gate without a host read
(:func:`merge_resample_gated`): K3a takes the log weights and their
normalizers, computes the gate from them and writes it to the device
(``[fire, bad | fire]``), and it and pass 2 do nothing more where the
gate is off; the step kernel then reads the gate too
(``ops/pf_cuda.py``).

Its ``pass2="compressed"`` form reads pass 2 from a survivor stack, as
the JAX merge's does:

* :func:`compact_particles` (kernel, K3c): each 1024-lane block's
  survivors, their values and their slot intervals ``[t_lo, t_hi)``, to
  the block's leading columns, and the block's count;
* :func:`expand_compressed` (kernel, K3d): each output slot's survivor
  in that stack and a copy of its values.  The stack's ``t_hi`` row is
  sorted and block k's survivors own the output slots
  ``[t_run(k - 1), t_run(k))``, its last ``t_hi`` before and its own, so
  a block a range of output slots (the single filter) or a window of
  stack blocks (the wide filter) stages just the live columns it needs,
  by the counts; the JAX package's gather of the survivors into one list
  is not needed.

The keywords map to launches so:

=============================  ====================  ===================
Call (both packages)           JAX launches          Port launches
=============================  ====================  ===================
``pass2="windowed"`` (default) K3a', K3b             K3a, K3b
``pass2="compressed"``         K3a', compress, K3d   K3a, K3c, K3d
=============================  ====================  ===================

Both give the same rows bit for bit.  The JAX ``fused=False`` (the
boundaries built by XLA, then ``_compact_kernel``) is a TPU schedule of
the same pass 1: here the boundaries always come from K3a, and
:func:`merge_options` refuses ``fused=False``.  The segmented forms
(:func:`compact_particles_seg`, :func:`expand_compressed_seg`) are the
wide filter's ``pass2="compressed"``; the single-filter K3c and K3d
launch the same kernels with the filter as their one slot, its flag the
gate's.

Each kernel wrapper has its plain twin (``*_plain``) on the same inputs,
and :func:`merge_resample_rows_plain` is the whole resample in plain
torch.  Dispatch is by device: a CPU tensor runs the plain twins; a CUDA
tensor launches the kernels or raises.

The TPU's scheduling machinery (bf16 splits and one-hot matmuls, skip
tables, the ``t_in``/``t_k``/``t_out``/``w_b`` caps and their small tiers,
and the XLA fallback behind them) is not ported: every weight profile
takes the same launches, and :func:`merge_options` refuses those caps.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpuslam_torch.filters.pf import (boundary_law, decode_slots,
                                      quantize_weights_law)
from tpuslam_torch.ops import _build

#: Lanes per compaction block: the kernels' ``kScanBlock``.
BLOCK = 1024
#: K3a's threads a block (``kBoundThreads``), each taking four lanes of
#: a tile of :data:`TILE`: they set the order of its float total.
BOUND_THREADS = 256
TILE = 4 * BOUND_THREADS
#: The forms of pass 2: the expand over all boundaries, or over the
#: compressed survivor list.
PASS2 = ("windowed", "compressed")


def quantize_weights(w_row: torch.Tensor):
    """The JAX package's merge prerequisites
    (``resample_pallas.quantize_weights``), with the row's sum in torch's
    order.

    Args:
        w_row: ``(n_pad,)`` float32 weights, padding lanes zero.

    Returns:
        ``(wq, base, q_tot)``: the ``(n_pad,)`` integer weights
        (:func:`~tpuslam_torch.filters.pf.quantize_weights_law` of the
        row's sum), the ``(ceil(n_pad / BLOCK),)`` exclusive prefix of
        their :data:`BLOCK`-lane block sums and their total, all float32.
        Sums of integers below ``2^24`` are exact in any order, so
        ``base[b]`` plus an in-block prefix equals the global cumsum.
        K3a takes its total in its own fixed order instead
        (:func:`boundary_total_plain`): the two agree where the sums do.
    """
    wq = quantize_weights_law(w_row, w_row.sum())
    pad = -wq.shape[0] % BLOCK
    sums = F.pad(wq, (0, pad)).view(-1, BLOCK).sum(dim=1)
    cum_blocks = torch.cumsum(sums, dim=0)
    return wq, cum_blocks - sums, cum_blocks[-1]


def _scalar(value, device: torch.device) -> torch.Tensor:
    """A float32 one-element tensor on ``device``: a device scalar is
    passed to the kernels by pointer, so reading it needs no host sync.
    A one-element float32 tensor there already is passed as it is."""
    if (isinstance(value, torch.Tensor) and value.numel() == 1
            and value.dtype == torch.float32 and value.device == device
            and value.is_contiguous()):
        return value
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).reshape(1)


def _boundaries(cum: torch.Tensor, inv_tot, offs, n: int) -> torch.Tensor:
    """The boundary law on the exact-integer prefix ``cum``, clipped to
    ``[0, n]``, every lane from ``n - 1`` on forced to ``n`` (the
    reference's trailing ``clip(idx, 0, n-1)`` as interval coverage)."""
    t = boundary_law(cum, _scalar(inv_tot, cum.device), n,
                     _scalar(offs, cum.device))
    t = t.to(torch.int32).clamp(0, n)
    t[n - 1:] = n
    return t


def slot_boundaries(w_row: torch.Tensor, n: int, offs) -> torch.Tensor:
    """Slot boundaries of the systematic comb, as the JAX package's
    ``slot_boundaries`` computes them (its total in torch's order):
    ``(n_pad,)`` int32, non-decreasing in ``[0, n]``; particle ``j`` owns
    the output slots ``[t[j-1], t[j])``."""
    wq, _, _ = quantize_weights(w_row)
    return slot_boundaries_from_wq(wq, n, offs)


def slot_boundaries_from_wq(wq_row: torch.Tensor, n: int,
                            offs) -> torch.Tensor:
    """Slot boundaries from pre-quantized integer weights (the same law
    as :func:`slot_boundaries` on the same integers)."""
    cum = torch.cumsum(wq_row, dim=0)
    return _boundaries(cum, 1.0 / cum[-1], offs, n)


def decode_indices(t_row: torch.Tensor, n: int) -> torch.Tensor:
    """Gather indices from slot boundaries: ``idx[i] = j`` with
    ``t[j-1] <= i < t[j]`` (:func:`~tpuslam_torch.filters.pf.decode_slots`
    of the first ``n`` lanes)."""
    return decode_slots(t_row[:n].to(torch.int64))


def _check_n(n: int, n_pad: int) -> None:
    if not 1 <= n <= n_pad:
        raise ValueError(f"n={n} must be in [1, n_pad={n_pad}]")
    if n_pad >= _build.MAX_N:
        raise ValueError("merge resample requires n_pad < 2**24 (f32-exact "
                         f"slot boundaries); got {n_pad}")


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (a power of two) by a tree of halving
    adds, level h: ``v[i] + v[i + h]``."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def boundary_total_plain(w: torch.Tensor) -> torch.Tensor:
    """The float32 total of ``(n,)`` weights in K3a's order: each tile of
    :data:`TILE` lanes sums thread t's four lanes ``4t .. 4t + 3`` in
    sequence, then a tree of halving adds over the
    :data:`BOUND_THREADS` threads; the tile sums are added so too (thread
    t: tiles ``t, t + T, ...`` in sequence from 0, then the tree).  Every
    add is one IEEE float32 add, as the kernel's ``__fadd_rn``."""
    n = w.shape[-1]
    tiles = -(-n // TILE)
    lanes = F.pad(w, (0, tiles * TILE - n)).view(tiles, BOUND_THREADS, 4)
    part = _tree(((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2])
                 + lanes[..., 3])
    rows = -(-tiles // BOUND_THREADS)
    part = F.pad(part, (0, rows * BOUND_THREADS - tiles)).view(
        rows, BOUND_THREADS)
    acc = torch.zeros(BOUND_THREADS, dtype=w.dtype, device=w.device)
    for r in range(rows):
        acc = acc + part[r]
    return _tree(acc)


def _weights(row: torch.Tensor, n: int, lse=None) -> torch.Tensor:
    """K3a's weights: the row, or ``exp(row - lse)``; lanes from ``n`` on
    0."""
    w = row if lse is None else torch.exp(row - lse)
    return F.pad(w[:n], (0, row.shape[0] - n))


def resample_boundary_plain(row: torch.Tensor, n: int, offs, *,
                            lse=None) -> torch.Tensor:
    """Plain twin of :func:`resample_boundary`: the weights (``row``, or
    ``exp(row - lse)`` of log weights), quantized by
    :func:`~tpuslam_torch.filters.pf.quantize_weights_law` of their
    :func:`boundary_total_plain`, their cumsum (exact integers below
    ``2^24``), ``1 / q_tot`` and the law."""
    w = _weights(row, n, lse)
    cum = torch.cumsum(quantize_weights_law(w, boundary_total_plain(w)),
                       dim=0)
    return _boundaries(cum, 1.0 / cum[-1], offs, n)


def _check_row(name: str, row: torch.Tensor, n: int,
               device: torch.device) -> int:
    n_pad = row.shape[-1]
    _check_n(n, n_pad)
    _build.check_tensor(name, row, (n_pad,), torch.float32, device)
    return n_pad


def _launch_boundary(form, row, n, n_pad, offs, lse=None, lse2=None,
                     ess_min=0.0, gate=None, out=None) -> torch.Tensor:
    """K3a's launch into ``out`` (or a fresh ``(n_pad,)`` int32 row),
    counted under ``form``."""
    device = row.device
    lib = _build.cuda_library(device)
    offs = _scalar(offs, device)
    t_hi = (torch.empty(n_pad, dtype=torch.int32, device=device)
            if out is None else out)
    ptr = _build.ptr
    _build.launch(form, lib.tpuslam_resample_boundary, device.index,
                  row.data_ptr(), ptr(lse), ptr(lse2), ess_min,
                  offs.data_ptr(), ptr(gate), t_hi.data_ptr(), n, n_pad)
    return t_hi


def resample_boundary(w_row: torch.Tensor, n: int, offs) -> torch.Tensor:
    """K3a on given weights: slot boundaries, one kernel launch.

    Args:
        w_row: ``(n_pad,)`` float32 weights (lanes from ``n`` on
            ignored).
        n: valid particle count.
        offs: the comb offset in [0, 1), a float or a one-element tensor.

    Returns:
        ``(n_pad,)`` int32 boundaries; a CPU tensor runs
        :func:`resample_boundary_plain`.
    """
    device = w_row.device
    if device.type == "cpu":
        return resample_boundary_plain(w_row, n, offs)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _launch_boundary("resample_boundary_weights", w_row, n,
                            _check_row("w_row", w_row, n, device), offs)


def ess_gate_plain(lse: torch.Tensor, lse2: torch.Tensor, n: int,
                   ess_min: float) -> torch.Tensor:
    """The single filter's ESS gate in torch: ``bad`` where a normalizer
    is not finite, ``ess = n`` there and ``exp(2 lse - lse2)`` elsewhere,
    ``fire = ess < ess_min`` (float32, as torch compares a tensor with a
    Python float).  Returns the ``(2,)`` bool gate ``[fire, bad | fire]``
    that K3a writes."""
    bad = ~(torch.isfinite(lse) & torch.isfinite(lse2))
    ess = torch.where(bad, float(n), torch.exp(2.0 * lse - lse2))
    fire = ess < ess_min
    return torch.stack([fire, bad | fire]).reshape(2)


def gated_boundary_plain(log_w: torch.Tensor, lse: torch.Tensor,
                         lse2: torch.Tensor, n: int, offs,
                         ess_min: float):
    """Plain twin of :func:`gated_boundary`.  Where the gate is off it
    decodes uniform weights (the kernel writes no boundary there), so its
    boundaries stay a partition of the slots."""
    gate = ess_gate_plain(lse, lse2, n, ess_min)
    fire = gate[0]
    t_hi = resample_boundary_plain(torch.where(fire, log_w, 0.0), n, offs,
                                   lse=torch.where(fire, lse, 0.0))
    return t_hi, gate


def gated_boundary(log_w: torch.Tensor, lse: torch.Tensor,
                   lse2: torch.Tensor, n: int, offs, ess_min: float, *,
                   out: torch.Tensor | None = None):
    """K3a on the single filter's ESS gate, one launch, no host read.

    Every block computes the gate from the two normalizers
    (:func:`ess_gate_plain`'s law, ``expf`` and float32 on the card), the
    first writes it, and where it is off every block exits.

    Args:
        log_w: ``(n_pad,)`` float32 log weights (lanes from ``n`` on
            ignored); lse, lse2: their normalizers, one-element float32
            tensors on the device.
        n: valid particle count.
        offs: the comb offset in [0, 1), a float or a one-element tensor.
        ess_min: the gate's threshold, ``n * ess_threshold_frac``.
        out: optional ``(n_pad,)`` int32 row to write.

    Returns:
        ``(t_hi, gate)``: the ``(n_pad,)`` int32 boundaries of the weights
        ``exp(log_w - lse)`` (written only where the gate fires) and the
        ``(2,)`` bool gate ``[fire, bad | fire]``.  A CPU tensor runs
        :func:`gated_boundary_plain`.
    """
    device = log_w.device
    if device.type == "cpu":
        return gated_boundary_plain(log_w, lse, lse2, n, offs, ess_min)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = _check_row("log_w", log_w, n, device)
    for name, t in (("lse", lse), ("lse2", lse2)):
        _build.check_tensor(name, t, t.shape, torch.float32, device)
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value")
    if out is not None:
        _build.check_tensor("out", out, (n_pad,), torch.int32, device)
    gate = torch.empty(2, dtype=torch.bool, device=device)
    t_hi = _launch_boundary("resample_boundary", log_w, n, n_pad, offs, lse,
                            lse2, ctypes.c_float(ess_min).value, gate, out)
    return t_hi, gate


def boundary_arrivals(device: torch.device | str) -> int:
    """K3a's grid-barrier arrivals on ``device`` (0 between launches).
    Reads the device: for checks only."""
    return _build.read_word("tpuslam_resample_arrivals", device)


def _slot0(device: torch.device):
    """``(fids, valid)`` of the single filter as slot 0: ``[0]`` and
    ``[True]`` on ``device``, made once."""
    return _build.cached(
        ("slot0", device),
        lambda: (torch.zeros(1, dtype=torch.int32, device=device),
                 torch.ones(1, dtype=torch.bool, device=device)))


def _one_slot(gate: torch.Tensor | None, device: torch.device):
    """``(fids, valid)`` of a single-filter launch: slot 0, valid where
    ``gate`` (the ``(2,)`` gate of :func:`gated_boundary`, its byte 0 the
    flag) fires, or always."""
    fids, always = _slot0(device)
    if gate is None:
        return fids, always
    _build.check_tensor("gate", gate, (2,), torch.bool, device)
    return fids, gate


def resample_expand_plain(p_rows: torch.Tensor, t_hi: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Plain twin of :func:`resample_expand`: :func:`decode_indices`, then
    a gather; padding lanes zero."""
    out = torch.zeros_like(p_rows)
    out[:, :n] = p_rows[:, decode_indices(t_hi, n)]
    return out


def resample_expand(p_rows: torch.Tensor, t_hi: torch.Tensor, n: int, *,
                    gate: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K3b: every output slot's source particle and a copy of its values,
    one kernel launch (a block a range of output slots, so a particle that
    takes many slots does not fall to one block; the segmented form,
    :func:`resample_expand_seg`, keeps a block a window of particles).

    Args:
        p_rows: ``(3, n_pad)`` float32 particle rows.
        t_hi: ``(n_pad,)`` int32 boundaries (:func:`resample_boundary`).
        n: valid particle count.
        gate: optional ``(2,)`` bool gate (:func:`gated_boundary`): the
            launch writes nothing where it does not fire.
        out: optional ``(3, n_pad)`` float32 rows to write.

    Returns:
        The ``(3, n_pad)`` resampled rows, padding lanes zero; a CPU
        tensor runs :func:`resample_expand_plain` (which ignores the
        gate).
    """
    device = p_rows.device
    if device.type == "cpu":
        return resample_expand_plain(p_rows, t_hi, n)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = p_rows.shape[-1]
    _check_n(n, n_pad)
    _build.check_tensor("p_rows", p_rows, (3, n_pad), torch.float32, device)
    _build.check_tensor("t_hi", t_hi, (n_pad,), torch.int32, device)
    if out is not None:
        _build.check_tensor("out", out, (3, n_pad), torch.float32, device)
    valid = _one_slot(gate, device)[1]
    lib = _build.cuda_library(device)
    out = torch.empty_like(p_rows) if out is None else out
    _build.launch("resample_expand", lib.tpuslam_resample_expand,
                  device.index, p_rows.data_ptr(), t_hi.data_ptr(),
                  valid.data_ptr(), out.data_ptr(), n, n_pad)
    return out


def _check_seg(p_rows: torch.Tensor, t_hi: torch.Tensor, fids: torch.Tensor,
               valid: torch.Tensor) -> tuple[int, int]:
    device = p_rows.device
    if t_hi.dim() != 2:
        raise ValueError(f"t_hi must be (B, n), got {tuple(t_hi.shape)}")
    b, n = t_hi.shape
    _check_n(n, n)
    if b > 65535:
        raise ValueError(f"at most 65535 slots, got {b}")
    _build.check_tensor("p_rows", p_rows, (3, b, n), torch.float32, device)
    _build.check_tensor("t_hi", t_hi, (b, n), torch.int32, device)
    _build.check_tensor("fids", fids, (b,), torch.int32, device)
    _build.check_tensor("valid", valid, (b,), torch.bool, device)
    return b, n


def resample_expand_seg_plain(p_rows: torch.Tensor, t_hi: torch.Tensor,
                              fids: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`resample_expand_seg`: :func:`decode_indices`
    of each valid slot's boundaries, then a gather from its filter's
    rows; idle slots' rows are 0."""
    _, n = _check_seg(p_rows, t_hi, fids, valid)
    t = torch.where(valid[:, None], t_hi, n).to(torch.int64)
    idx = decode_slots(t)
    out = p_rows[:, fids.to(torch.int64)[:, None], idx]
    return torch.where(valid[None, :, None], out, 0.0)


def resample_expand_seg(p_rows: torch.Tensor, t_hi: torch.Tensor,
                        fids: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """K3b in segments (the wide filter's pass B), one kernel launch.

    Args:
        p_rows: ``(3, B, n)`` particle rows of B filters.
        t_hi: ``(B, n)`` int32 boundaries in slot order (K5a's).
        fids: ``(B,)`` int32, slot s's filter.
        valid: ``(B,)`` bool, whether slot s serves a firing filter.

    Returns:
        ``(3, B, n)``: slot s's resampled rows at s.  Only the valid
        slots' rows are written; a CPU tensor runs
        :func:`resample_expand_seg_plain`.
    """
    device = p_rows.device
    if device.type == "cpu":
        return resample_expand_seg_plain(p_rows, t_hi, fids, valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b, n = _check_seg(p_rows, t_hi, fids, valid)
    lib = _build.cuda_library(device)
    out = torch.empty_like(p_rows)
    _build.launch("resample_expand_seg", lib.tpuslam_resample_expand_seg,
                  device.index, p_rows.data_ptr(), t_hi.data_ptr(),
                  fids.data_ptr(), valid.data_ptr(), out.data_ptr(), n, b)
    return out


def compact_particles_plain(p: torch.Tensor, t: torch.Tensor):
    """Plain twin of :func:`compact_particles`, over rows ``t`` of shape
    ``(..., L)`` and their particles ``p`` of shape ``(3, ..., L)``; each
    row starts from ``t_{-1} = 0``."""
    length = t.shape[-1]
    nblk = -(-length // BLOCK)
    t_prev = F.pad(t[..., :-1], (1, 0))
    flags = F.pad((t > t_prev).to(torch.int32), (0, nblk * BLOCK - length))
    incl = torch.cumsum(flags.unflatten(-1, (nblk, BLOCK)), -1,
                        dtype=torch.int32)
    cnt = incl[..., -1].contiguous()
    # Column k of a block holds the lane whose inclusive rank is k + 1.
    k = torch.arange(BLOCK, dtype=torch.int32,
                     device=t.device).expand_as(incl).contiguous()
    col0 = torch.arange(nblk, device=t.device)[:, None] * BLOCK
    src = (torch.searchsorted(incl, k, right=True) + col0).flatten(-2)
    src = src[..., :length].clamp(max=length - 1)
    live = (k < cnt[..., None]).flatten(-2)[..., :length]
    last = (col0[:, 0] + BLOCK).clamp(max=length) - 1
    t_run = t[..., last].repeat_interleave(BLOCK, dim=-1)[..., :length]
    vals = torch.where(live, p.gather(-1, src.expand_as(p)), 0.0)
    iv = torch.where(live, torch.stack([t_prev.gather(-1, src),
                                        t.gather(-1, src)]), t_run)
    return vals, iv, cnt


def _slots(rows: torch.Tensor) -> int:
    """The slots of ``(3, len)`` rows (one) or ``(3, b, len)`` rows."""
    return 1 if rows.dim() == 2 else rows.shape[1]


def _launch_compact(form: str, p_rows: torch.Tensor, t_hi: torch.Tensor,
                    fids: torch.Tensor, valid: torch.Tensor):
    """K3c's launch over the slots of ``(3, len)`` (one slot) or
    ``(3, b, len)`` rows (checked by the caller), counted under ``form``;
    the stack takes their shape, so the single filter's launch makes no
    view."""
    length, b = p_rows.shape[-1], _slots(p_rows)
    device = p_rows.device
    lib = _build.cuda_library(device)
    vals = torch.empty_like(p_rows)
    iv = torch.empty((2,) + p_rows.shape[1:], dtype=torch.int32,
                     device=device)
    cnt = torch.empty(p_rows.shape[1:-1] + (-(-length // BLOCK),),
                      dtype=torch.int32, device=device)
    _build.launch(form, lib.tpuslam_resample_compact, device.index,
                  p_rows.data_ptr(), t_hi.data_ptr(), fids.data_ptr(),
                  valid.data_ptr(), vals.data_ptr(), iv.data_ptr(),
                  cnt.data_ptr(), length, b)
    return vals, iv, cnt


def compact_particles(p_rows: torch.Tensor, t_hi: torch.Tensor, *,
                      gate: torch.Tensor | None = None):
    """K3c: each :data:`BLOCK`-lane block's survivors compacted, one
    kernel launch (the filter as the one slot of
    :func:`compact_particles_seg`'s kernel).

    Args:
        p_rows: ``(3, n_pad)`` float32 particle rows.
        t_hi: ``(n_pad,)`` int32 boundaries (:func:`resample_boundary`;
            lanes from ``n - 1`` on carry ``n``).
        gate: optional ``(2,)`` bool gate (:func:`gated_boundary`): where
            it does not fire the launch writes zero counts only (a CPU
            tensor ignores it).

    Returns:
        ``(vals, iv, cnt)``: the ``(3, n_pad)`` float32 values and
        ``(2, n_pad)`` int32 slot intervals ``(t_lo, t_hi)`` of block b's
        survivors (``t_hi[j] > t_hi[j - 1]``) in columns
        ``b * BLOCK + rank``; the block's later columns zero values and the
        empty interval at its last boundary, so the ``t_hi`` row is sorted;
        ``cnt``, the ``(ceil(n_pad / BLOCK),)`` int32 survivors a block.
    """
    device = p_rows.device
    if device.type == "cpu":
        return compact_particles_plain(p_rows, t_hi)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = p_rows.shape[-1]
    _build.check_tensor("p_rows", p_rows, (3, n_pad), torch.float32, device)
    _build.check_tensor("t_hi", t_hi, (n_pad,), torch.int32, device)
    return _launch_compact("compact", p_rows, t_hi, *_one_slot(gate, device))


def compact_particles_seg_plain(p_rows: torch.Tensor, t_hi: torch.Tensor,
                                fids: torch.Tensor, valid: torch.Tensor):
    """Plain twin of :func:`compact_particles_seg`; idle slots' rows and
    counts are 0."""
    _check_seg(p_rows, t_hi, fids, valid)
    vals, iv, cnt = compact_particles_plain(p_rows[:, fids.to(torch.int64)],
                                            t_hi)
    return (torch.where(valid[:, None], vals, 0.0),
            torch.where(valid[:, None], iv, 0),
            torch.where(valid[:, None], cnt, 0))


def compact_particles_seg(p_rows: torch.Tensor, t_hi: torch.Tensor,
                          fids: torch.Tensor, valid: torch.Tensor):
    """K3c in segments (the wide filter's compressed pass B), one kernel
    launch: slot s compacts its filter ``fids[s]``'s particles by its
    boundaries ``t_hi[s]`` (K5a's, slot order).

    Returns:
        ``(vals, iv, cnt)`` of shapes ``(3, B, n)``, ``(2, B, n)`` and
        ``(B, ceil(n / BLOCK))``, slot s's stack at s as
        :func:`compact_particles` gives it.  Only the valid slots' stack
        rows are written; the idle slots' counts are 0.
    """
    device = p_rows.device
    if device.type == "cpu":
        return compact_particles_seg_plain(p_rows, t_hi, fids, valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_seg(p_rows, t_hi, fids, valid)
    return _launch_compact("compact_seg", p_rows, t_hi, fids, valid)


def _check_partition(iv: torch.Tensor, idx: torch.Tensor, i: torch.Tensor,
                     idle: torch.Tensor | None = None) -> None:
    """Raise unless every output slot's column ``idx`` has an interval
    that holds the slot (idle rows aside)."""
    held = ((iv[0].gather(-1, idx) <= i) & (iv[1].gather(-1, idx) > i))
    if idle is not None:
        held |= idle
    if not bool(held.all()):
        raise ValueError("the survivor stack does not partition the output "
                         "slots")


def expand_compressed_plain(vals: torch.Tensor, iv: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Plain twin of :func:`expand_compressed`: a search of the stack's
    sorted ``t_hi`` row, a check that each slot's interval holds it, a
    gather; padding lanes zero."""
    i = torch.arange(n, dtype=torch.int32, device=iv.device)
    idx = torch.searchsorted(iv[1], i, right=True).clamp_(max=n - 1)
    _check_partition(iv, idx, i)
    out = torch.zeros_like(vals)
    out[:, :n] = vals[:, idx]
    return out


def _check_stack_seg(vals: torch.Tensor, iv: torch.Tensor,
                     valid: torch.Tensor) -> tuple[int, int]:
    device = vals.device
    if vals.dim() != 3:
        raise ValueError(f"vals must be (3, B, n), got {tuple(vals.shape)}")
    _, b, length = vals.shape
    _check_n(length, length)
    if b > 65535:
        raise ValueError(f"at most 65535 slots, got {b}")
    _build.check_tensor("vals", vals, (3, b, length), torch.float32, device)
    _build.check_tensor("iv", iv, (2, b, length), torch.int32, device)
    _build.check_tensor("valid", valid, (b,), torch.bool, device)
    return b, length


def _launch_expand_compressed(form: str, vals: torch.Tensor,
                              iv: torch.Tensor, cnt: torch.Tensor | None,
                              valid: torch.Tensor, n: int) -> torch.Tensor:
    """K3d's launch over the slots of a ``(3, len)`` (one slot) or
    ``(3, b, len)`` stack (checked by the caller) and its counts, which
    the kernels stage the live columns by; counted under ``form``."""
    length, b = vals.shape[-1], _slots(vals)
    _check_n(n, length)
    device = vals.device
    if cnt is None:
        raise ValueError("K3d on the card reads the stack's counts: pass "
                         "cnt=, the third output of the compaction")
    _build.check_tensor("cnt", cnt, vals.shape[1:-1] + (-(-length // BLOCK),),
                        torch.int32, device)
    lib = _build.cuda_library(device)
    out = torch.empty_like(vals)
    _build.launch(form, lib.tpuslam_resample_expand_compressed, device.index,
                  vals.data_ptr(), iv.data_ptr(), cnt.data_ptr(),
                  valid.data_ptr(), out.data_ptr(), n, length, b)
    return out


def expand_compressed(vals: torch.Tensor, iv: torch.Tensor, n: int, *,
                      cnt: torch.Tensor | None = None,
                      gate: torch.Tensor | None = None) -> torch.Tensor:
    """K3d: every output slot's survivor in the stack and a copy of its
    values, one kernel launch (a block a range of output slots, which
    stages the survivors of its range; the segmented form,
    :func:`expand_compressed_seg`, takes a block a window of stack
    blocks).

    Args:
        vals, iv: the stack from :func:`compact_particles`.
        n: valid particle count.
        cnt: its ``(ceil(n_pad / BLOCK),)`` counts, required on the card
            (the plain twin needs none).
        gate: optional ``(2,)`` bool gate (:func:`gated_boundary`): the
            launch writes nothing where it does not fire (a CPU tensor
            ignores it).

    Returns:
        The ``(3, n_pad)`` resampled rows, padding lanes zero.
    """
    device = vals.device
    if device.type == "cpu":
        return expand_compressed_plain(vals, iv, n)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = vals.shape[-1]
    _build.check_tensor("vals", vals, (3, n_pad), torch.float32, device)
    _build.check_tensor("iv", iv, (2, n_pad), torch.int32, device)
    return _launch_expand_compressed("expand_compressed", vals, iv, cnt,
                                     _one_slot(gate, device)[1], n)


def expand_compressed_seg_plain(vals: torch.Tensor, iv: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`expand_compressed_seg`; idle slots' rows
    are 0."""
    b, n = _check_stack_seg(vals, iv, valid)
    i = torch.arange(n, dtype=torch.int32,
                     device=iv.device).expand(b, n).contiguous()
    idx = torch.searchsorted(iv[1], i, right=True).clamp_(max=n - 1)
    _check_partition(iv, idx, i, ~valid[:, None])
    out = vals.gather(-1, idx.expand_as(vals))
    return torch.where(valid[None, :, None], out, 0.0)


def expand_compressed_seg(vals: torch.Tensor, iv: torch.Tensor,
                          valid: torch.Tensor, *,
                          cnt: torch.Tensor | None = None) -> torch.Tensor:
    """K3d in segments (the wide filter's compressed pass B), one kernel
    launch: slot s expands its own stack row into its output row, a block
    a window of stack blocks and a slot (one slot: a block a range of
    output slots, as :func:`expand_compressed`).

    Args:
        vals, iv: a :func:`compact_particles_seg` stack, ``(3, B, n)`` and
            ``(2, B, n)``.
        valid: ``(B,)`` bool, whether slot s serves a firing filter.
        cnt: the stack's ``(B, ceil(n / BLOCK))`` counts, required on the
            card (the plain twin needs none).

    Returns:
        ``(3, B, n)``: slot s's resampled rows at s, as
        :func:`resample_expand_seg` gives them.  Only the valid slots'
        rows are written.
    """
    device = vals.device
    if device.type == "cpu":
        return expand_compressed_seg_plain(vals, iv, valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_stack_seg(vals, iv, valid)
    return _launch_expand_compressed("expand_compressed_seg", vals, iv, cnt,
                                     valid, vals.shape[-1])


def check_pass2(pass2: str) -> None:
    if pass2 not in PASS2:
        raise ValueError(f"pass2 must be one of {PASS2}, got {pass2!r}")


def merge_options(merge_caps_kw: tuple = ()) -> dict:
    """The JAX package's ``merge_caps_kw`` (hashable ``(name, value)``
    pairs for its ``merge_resample_rows``) as keywords of the port's.

    Only ``pass2`` chooses a path here.  ``("fused", True)``, the JAX
    default, is what the port always does (pass 1 by K3a) and is dropped.
    ``("fused", False)`` (pass 1 by XLA and ``_compact_kernel``, a TPU
    schedule) and every cap of the TPU's kernels (``t_in``, ``t_k``,
    ``t_out``, ``w_b``, ``w_b_small``, ``t_k_small``) raise a
    ``ValueError`` naming the entry.
    """
    opts = {}
    for name, value in merge_caps_kw:
        if name == "pass2":
            check_pass2(value)
            opts[name] = value
        elif not (name == "fused" and value is True):
            raise ValueError(f"merge_caps_kw entry ({name!r}, {value!r}) has "
                             "no counterpart on the card: only 'pass2' "
                             "chooses a path there, pass 1 is always the "
                             "boundary kernel (fused=True), and the TPU's "
                             "caps are not ported")
    return opts


def _pass2(p_rows: torch.Tensor, t_hi: torch.Tensor, n: int, pass2: str,
           plain: bool, gate: torch.Tensor | None = None) -> torch.Tensor:
    """Pass 2 of the merge from the boundaries: K3b, or K3c and K3d, on
    ``gate`` where one is given (their plain twins with ``plain``, which
    take no gate)."""
    if plain:
        if pass2 == "windowed":
            return resample_expand_plain(p_rows, t_hi, n)
        vals, iv, _ = compact_particles_plain(p_rows, t_hi)
        return expand_compressed_plain(vals, iv, n)
    if pass2 == "windowed":
        return resample_expand(p_rows, t_hi, n, gate=gate)
    vals, iv, cnt = compact_particles(p_rows, t_hi, gate=gate)
    return expand_compressed(vals, iv, n, cnt=cnt, gate=gate)


def expand_seg(p_rows: torch.Tensor, t_hi: torch.Tensor, fids: torch.Tensor,
               valid: torch.Tensor, pass2: str = "windowed") -> torch.Tensor:
    """The wide filter's pass B in either form: :func:`resample_expand_seg`
    (``"windowed"``), or :func:`compact_particles_seg` and
    :func:`expand_compressed_seg` (``"compressed"``).  The valid slots'
    rows are equal bit for bit."""
    if pass2 == "windowed":
        return resample_expand_seg(p_rows, t_hi, fids, valid)
    vals, iv, cnt = compact_particles_seg(p_rows, t_hi, fids, valid)
    return expand_compressed_seg(vals, iv, valid, cnt=cnt)


def _offs_on(offs, device: torch.device) -> torch.Tensor:
    if isinstance(offs, torch.Generator):
        return torch.rand(1, generator=offs, dtype=torch.float32,
                          device=device)
    return _scalar(offs, device)


def _check_rows(p_rows: torch.Tensor, w_row: torch.Tensor, n: int,
                device: torch.device) -> None:
    n_pad = p_rows.shape[-1]
    _build.check_tensor("p_rows", p_rows, (3, n_pad), torch.float32, device)
    _build.check_tensor("w_row", w_row, (n_pad,), torch.float32, device)
    _check_n(n, n_pad)


def merge_resample_rows_plain(p_rows: torch.Tensor, w_row: torch.Tensor,
                              n: int, offs, *, device: torch.device | str,
                              pass2: str = "windowed") -> torch.Tensor:
    """The resample in plain torch, on any device: quantize, boundaries,
    then :func:`decode_indices` and a gather, or (``pass2="compressed"``)
    the stack's plain twins.  Same arguments and return as
    :func:`merge_resample_rows`."""
    device = _build.resolve_device(device)
    _check_rows(p_rows, w_row, n, device)
    check_pass2(pass2)
    t_hi = resample_boundary_plain(w_row, n, _offs_on(offs, device))
    return _pass2(p_rows, t_hi, n, pass2, plain=True)


def merge_resample_rows(p_rows: torch.Tensor, w_row: torch.Tensor, n: int,
                        offs, *, device: torch.device | str,
                        pass2: str = "windowed") -> torch.Tensor:
    """Systematic resample of row-major particles.

    Selection is bit-identical to ``resample_indices(method="hist")`` on
    the same weights and offset where their totals agree (the kernel sums
    the weights in its own fixed order, :func:`boundary_total_plain`);
    values are copied exactly.

    Args:
        p_rows: ``(3, n_pad)`` float32 particle rows.
        w_row: ``(n_pad,)`` float32 normalized weights, padding lanes zero.
        n: valid particle count, ``n < 2**24``.
        offs: the comb offset in [0, 1) in units of ``1/n`` (a float, a
            device scalar, or a ``torch.Generator`` to draw it from).
        device: required, and where the tensors lie; a CUDA device
            launches the kernels, the CPU runs
            :func:`merge_resample_rows_plain`.
        pass2: ``"windowed"``, the expand over the boundaries (K3b), or
            ``"compressed"``, the survivor stack (K3c) and the expand over
            it (K3d).  Both give the same rows bit for bit (the table in
            the module's docstring).

    Returns:
        ``(3, n_pad)`` resampled rows, padding lanes zero.
    """
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return merge_resample_rows_plain(p_rows, w_row, n, offs,
                                         device=device, pass2=pass2)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _build.cuda_library(device)
    _check_rows(p_rows, w_row, n, device)
    check_pass2(pass2)
    t_hi = resample_boundary(w_row, n, _offs_on(offs, device))
    return _pass2(p_rows, t_hi, n, pass2, plain=False)


def merge_resample_gated_plain(p_rows: torch.Tensor, log_w: torch.Tensor,
                               lse: torch.Tensor, lse2: torch.Tensor,
                               n: int, offs, ess_min: float, *,
                               pass2: str = "windowed"):
    """Plain twin of :func:`merge_resample_gated`, on any device: it
    resamples whatever the gate says (uniform weights where it is off)
    and reads nothing on the host."""
    check_pass2(pass2)
    t_hi, gate = gated_boundary_plain(log_w, lse, lse2, n, offs, ess_min)
    return _pass2(p_rows, t_hi, n, pass2, plain=True), gate


def merge_resample_gated(p_rows: torch.Tensor, log_w: torch.Tensor,
                         lse: torch.Tensor, lse2: torch.Tensor, n: int,
                         offs, ess_min: float, *,
                         pass2: str = "windowed"):
    """The single filter's merge on its ESS gate, with no host read:
    :func:`gated_boundary` (K3a on the log weights, writing the gate),
    then pass 2 (K3b, or K3c and K3d) on that gate.  Every launch reads
    the gate on the device and does nothing where it is off.

    Args:
        p_rows: ``(3, n_pad)`` float32 particle rows; log_w: ``(n_pad,)``
            their log weights; lse, lse2: the normalizers (one-element
            tensors); n, offs, ess_min, pass2: as :func:`gated_boundary`
            and :func:`merge_resample_rows`.

    Returns:
        ``(rows, gate)``: the resampled ``(3, n_pad)`` rows (written only
        where the gate fires) and the ``(2,)`` bool gate ``[fire,
        bad | fire]``.  A CPU tensor runs :func:`merge_resample_gated_plain`.
    """
    if log_w.device.type == "cpu":
        return merge_resample_gated_plain(p_rows, log_w, lse, lse2, n, offs,
                                          ess_min, pass2=pass2)
    check_pass2(pass2)
    _build.check_tensor("p_rows", p_rows, (3, log_w.shape[-1]),
                        torch.float32, log_w.device)
    t_hi, gate = gated_boundary(log_w, lse, lse2, n, offs, ess_min)
    return _pass2(p_rows, t_hi, n, pass2, plain=False, gate=gate), gate
