"""The systematic merge resample: K3 as CUDA kernels and their plain
twins.

Port of ``tpuslam/ops/resample_pallas.py``.  :func:`merge_resample_rows`
resamples ``(3, n_pad)`` particle rows by their weights with the
selection of ``filters/pf.py::resample_indices(method="hist")``, bit for
bit, and copies the float32 values exactly.  Its form on the card is
prefix -> boundary -> slots -> copy (see ``csrc/resample.cu``):

* shared prerequisites, in plain torch, once (:func:`quantize_weights`):
  the weights quantized to integers of ``2^-20`` of their total, the
  exclusive prefix of their 1024-lane block sums, and the total;
  ``inv_tot = 1 / q_tot`` in float32;
* :func:`resample_boundary` (kernel, K3a): the exact in-block prefix
  plus the base, the boundary law, the forcing ``t[n-1] = n``;
* :func:`resample_expand` (kernel, K3b): each output slot's source
  particle and the copy of its values;
* :func:`resample_expand_seg` (the same kernel in segments): the wide
  batched filter's pass B, each firing slot expanding its own filter.

Its ``pass2="compressed"`` form reads pass 2 from a survivor stack, as
the JAX merge's does:

* :func:`compact_particles` (kernel, K3c): each 1024-lane block's
  survivors, their values and their slot intervals ``[t_lo, t_hi)``, to
  the block's leading columns, and the block's count;
* :func:`expand_compressed` (kernel, K3d): each output slot's survivor,
  found by a search of that stack (its ``t_hi`` row is sorted, so the
  JAX package's gather of the survivors into one list is not needed),
  and a copy of its values from it.

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
wide filter's ``pass2="compressed"``; the single-filter forms launch the
same kernels with the filter as their one slot.

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

import torch
import torch.nn.functional as F

from tpuslam_torch.filters.pf import (boundary_law, decode_slots,
                                      quantize_weights_law)
from tpuslam_torch.ops import _build

#: Launches of each CUDA kernel since its count was last set to 0.
boundary_launch_count = 0
expand_launch_count = 0
expand_seg_launch_count = 0
compact_launch_count = 0
compact_seg_launch_count = 0
expand_compressed_launch_count = 0
expand_compressed_seg_launch_count = 0

#: Lanes per boundary and compaction block: the kernels' ``kScanBlock``.
BLOCK = 1024
_MAX_N = 1 << 24  # boundaries and integer prefixes exact in float32
#: The forms of pass 2: the expand over all boundaries, or over the
#: compressed survivor list.
PASS2 = ("windowed", "compressed")


def quantize_weights(w_row: torch.Tensor):
    """The resample's plain-torch prerequisites.

    Args:
        w_row: ``(n_pad,)`` float32 weights, padding lanes zero.

    Returns:
        ``(wq, base, q_tot)``: the ``(n_pad,)`` integer weights
        (:func:`~tpuslam_torch.filters.pf.quantize_weights_law` of the
        row's sum), the ``(ceil(n_pad / BLOCK),)`` exclusive prefix of
        their :data:`BLOCK`-lane block sums and their total, all float32.
        Sums of integers below ``2^24`` are exact in any order, so
        ``base[b]`` plus an in-block prefix equals the global cumsum.
    """
    wq = quantize_weights_law(w_row, w_row.sum())
    pad = -wq.shape[0] % BLOCK
    sums = F.pad(wq, (0, pad)).view(-1, BLOCK).sum(dim=1)
    cum_blocks = torch.cumsum(sums, dim=0)
    return wq, cum_blocks - sums, cum_blocks[-1]


def _finish_boundaries(t: torch.Tensor, n: int) -> torch.Tensor:
    """Clip to ``[0, n]`` and force every lane from ``n - 1`` on to
    ``n`` (the reference's trailing ``clip(idx, 0, n-1)`` as interval
    coverage)."""
    t = t.to(torch.int32).clamp(0, n)
    t[n - 1:] = n
    return t


def slot_boundaries(w_row: torch.Tensor, n: int, offs) -> torch.Tensor:
    """Slot boundaries of the systematic comb: ``(n_pad,)`` int32,
    non-decreasing in ``[0, n]``; particle ``j`` owns the output slots
    ``[t[j-1], t[j])``."""
    wq, _, _ = quantize_weights(w_row)
    return slot_boundaries_from_wq(wq, n, offs)


def slot_boundaries_from_wq(wq_row: torch.Tensor, n: int,
                            offs) -> torch.Tensor:
    """Slot boundaries from pre-quantized integer weights (the same law
    as :func:`slot_boundaries` on the same integers)."""
    q_tot = torch.cumsum(wq_row, dim=0)[-1]
    return resample_boundary_plain(wq_row, 1.0 / q_tot, offs, n)


def decode_indices(t_row: torch.Tensor, n: int) -> torch.Tensor:
    """Gather indices from slot boundaries: ``idx[i] = j`` with
    ``t[j-1] <= i < t[j]`` (:func:`~tpuslam_torch.filters.pf.decode_slots`
    of the first ``n`` lanes)."""
    return decode_slots(t_row[:n].to(torch.int64))


def _check_n(n: int, n_pad: int) -> None:
    if not 1 <= n <= n_pad:
        raise ValueError(f"n={n} must be in [1, n_pad={n_pad}]")
    if n >= _MAX_N:
        raise ValueError("merge resample requires n < 2**24 (f32-exact "
                         f"slot boundaries); got {n}")


def _scalar(value, device: torch.device) -> torch.Tensor:
    """A float32 one-element tensor on ``device``: a device scalar is
    passed to the kernels by pointer, so reading it needs no host sync."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).reshape(1)


def resample_boundary_plain(wq: torch.Tensor, inv_tot, offs,
                            n: int) -> torch.Tensor:
    """Plain twin of :func:`resample_boundary` (global cumsum in place of
    the block prefix plus base; equal for integers below ``2^24``)."""
    cum = torch.cumsum(wq, dim=0)
    inv_tot = _scalar(inv_tot, wq.device)
    offs = _scalar(offs, wq.device)
    return _finish_boundaries(boundary_law(cum, inv_tot, n, offs), n)


def resample_boundary(wq: torch.Tensor, base: torch.Tensor, inv_tot, offs,
                      n: int) -> torch.Tensor:
    """K3a: slot boundaries from the quantized weights, one kernel launch.

    Args:
        wq, base: from :func:`quantize_weights`.
        inv_tot: ``1 / q_tot`` as a float32 scalar or one-element tensor.
        offs: the comb offset in [0, 1), likewise.
        n: valid particle count.

    Returns:
        ``(n_pad,)`` int32 boundaries, as :func:`slot_boundaries`.
    """
    global boundary_launch_count
    device = wq.device
    if device.type == "cpu":
        return resample_boundary_plain(wq, inv_tot, offs, n)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = wq.shape[0]
    _check_n(n, n_pad)
    _build.check_tensor("wq", wq, (n_pad,), torch.float32, device)
    _build.check_tensor("base", base, (-(-n_pad // BLOCK),), torch.float32,
                        device)
    lib = _build.cuda_library(device)
    inv_tot, offs = _scalar(inv_tot, device), _scalar(offs, device)
    with torch.cuda.device(device):
        t_hi = torch.empty(n_pad, dtype=torch.int32, device=device)
        rc = lib.tpuslam_resample_boundary(
            wq.data_ptr(), base.data_ptr(), inv_tot.data_ptr(),
            offs.data_ptr(), t_hi.data_ptr(), n, n_pad,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resample_boundary kernel launch failed: CUDA "
                           f"error {rc}")
    boundary_launch_count += 1
    return t_hi


def resample_expand_plain(p_rows: torch.Tensor, t_hi: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Plain twin of :func:`resample_expand`: :func:`decode_indices`, then
    a gather; padding lanes zero."""
    out = torch.zeros_like(p_rows)
    out[:, :n] = p_rows[:, decode_indices(t_hi, n)]
    return out


def resample_expand(p_rows: torch.Tensor, t_hi: torch.Tensor,
                    n: int) -> torch.Tensor:
    """K3b: every output slot's source particle and a copy of its values,
    one kernel launch.  Returns the ``(3, n_pad)`` resampled rows."""
    global expand_launch_count
    device = p_rows.device
    if device.type == "cpu":
        return resample_expand_plain(p_rows, t_hi, n)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = p_rows.shape[-1]
    _check_n(n, n_pad)
    _build.check_tensor("p_rows", p_rows, (3, n_pad), torch.float32, device)
    _build.check_tensor("t_hi", t_hi, (n_pad,), torch.int32, device)
    lib = _build.cuda_library(device)
    with torch.cuda.device(device):
        out = torch.empty_like(p_rows)
        rc = lib.tpuslam_resample_expand(
            p_rows.data_ptr(), t_hi.data_ptr(), out.data_ptr(), n, n_pad,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resample_expand kernel launch failed: CUDA "
                           f"error {rc}")
    expand_launch_count += 1
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
    global expand_seg_launch_count
    device = p_rows.device
    if device.type == "cpu":
        return resample_expand_seg_plain(p_rows, t_hi, fids, valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b, n = _check_seg(p_rows, t_hi, fids, valid)
    lib = _build.cuda_library(device)
    with torch.cuda.device(device):
        out = torch.empty_like(p_rows)
        rc = lib.tpuslam_resample_expand_seg(
            p_rows.data_ptr(), t_hi.data_ptr(), fids.data_ptr(),
            valid.data_ptr(), out.data_ptr(), n, b,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resample_expand_seg kernel launch failed: CUDA "
                           f"error {rc}")
    expand_seg_launch_count += 1
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


def _one_slot(device: torch.device):
    """The single filter as the one slot of a segmented launch: ``fids``
    ``[0]`` and ``valid`` ``[True]``, made on ``device`` with no host
    sync."""
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.ones(1, dtype=torch.bool, device=device))


def _launch_compact(p_rows: torch.Tensor, t_hi: torch.Tensor,
                    fids: torch.Tensor, valid: torch.Tensor):
    """K3c's launch over the slots of ``(3, b, len)`` rows."""
    b, length = _check_seg(p_rows, t_hi, fids, valid)
    device = p_rows.device
    lib = _build.cuda_library(device)
    with torch.cuda.device(device):
        vals = torch.empty_like(p_rows)
        iv = torch.empty((2, b, length), dtype=torch.int32, device=device)
        cnt = torch.empty((b, -(-length // BLOCK)), dtype=torch.int32,
                          device=device)
        rc = lib.tpuslam_resample_compact(
            p_rows.data_ptr(), t_hi.data_ptr(), fids.data_ptr(),
            valid.data_ptr(), vals.data_ptr(), iv.data_ptr(),
            cnt.data_ptr(), length, b,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resample_compact kernel launch failed: CUDA "
                           f"error {rc}")
    return vals, iv, cnt


def compact_particles(p_rows: torch.Tensor, t_hi: torch.Tensor):
    """K3c: each :data:`BLOCK`-lane block's survivors compacted, one
    kernel launch (the filter as the one slot of
    :func:`compact_particles_seg`'s kernel).

    Args:
        p_rows: ``(3, n_pad)`` float32 particle rows.
        t_hi: ``(n_pad,)`` int32 boundaries (:func:`resample_boundary`;
            lanes from ``n - 1`` on carry ``n``).

    Returns:
        ``(vals, iv, cnt)``: the ``(3, n_pad)`` float32 values and
        ``(2, n_pad)`` int32 slot intervals ``(t_lo, t_hi)`` of block b's
        survivors (``t_hi[j] > t_hi[j - 1]``) in columns
        ``b * BLOCK + rank``; the block's later columns zero values and the
        empty interval at its last boundary, so the ``t_hi`` row is sorted;
        ``cnt``, the ``(ceil(n_pad / BLOCK),)`` int32 survivors a block.
    """
    global compact_launch_count
    device = p_rows.device
    if device.type == "cpu":
        return compact_particles_plain(p_rows, t_hi)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = p_rows.shape[-1]
    _build.check_tensor("p_rows", p_rows, (3, n_pad), torch.float32, device)
    _build.check_tensor("t_hi", t_hi, (n_pad,), torch.int32, device)
    vals, iv, cnt = _launch_compact(p_rows[:, None], t_hi[None],
                                    *_one_slot(device))
    compact_launch_count += 1
    return vals[:, 0], iv[:, 0], cnt[0]


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
    global compact_seg_launch_count
    device = p_rows.device
    if device.type == "cpu":
        return compact_particles_seg_plain(p_rows, t_hi, fids, valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    stack = _launch_compact(p_rows, t_hi, fids, valid)
    compact_seg_launch_count += 1
    return stack


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


def _launch_expand_compressed(vals: torch.Tensor, iv: torch.Tensor,
                              valid: torch.Tensor, n: int) -> torch.Tensor:
    """K3d's launch over the slots of a ``(3, b, len)`` stack."""
    b, length = _check_stack_seg(vals, iv, valid)
    _check_n(n, length)
    device = vals.device
    lib = _build.cuda_library(device)
    with torch.cuda.device(device):
        out = torch.empty_like(vals)
        rc = lib.tpuslam_resample_expand_compressed(
            vals.data_ptr(), iv.data_ptr(), valid.data_ptr(), out.data_ptr(),
            n, length, b, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resample_expand_compressed kernel launch "
                           f"failed: CUDA error {rc}")
    return out


def expand_compressed(vals: torch.Tensor, iv: torch.Tensor,
                      n: int) -> torch.Tensor:
    """K3d: every output slot's survivor in the stack and a copy of its
    values, one kernel launch (the filter as the one slot of
    :func:`expand_compressed_seg`'s kernel).

    Args:
        vals, iv: the stack from :func:`compact_particles`.
        n: valid particle count.

    Returns:
        The ``(3, n_pad)`` resampled rows, padding lanes zero.
    """
    global expand_compressed_launch_count
    device = vals.device
    if device.type == "cpu":
        return expand_compressed_plain(vals, iv, n)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_pad = vals.shape[-1]
    _build.check_tensor("vals", vals, (3, n_pad), torch.float32, device)
    _build.check_tensor("iv", iv, (2, n_pad), torch.int32, device)
    out = _launch_expand_compressed(vals[:, None], iv[:, None],
                                    _one_slot(device)[1], n)
    expand_compressed_launch_count += 1
    return out[:, 0]


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
                          valid: torch.Tensor) -> torch.Tensor:
    """K3d in segments (the wide filter's compressed pass B), one kernel
    launch: slot s expands its own stack row into its output row.

    Args:
        vals, iv: a :func:`compact_particles_seg` stack, ``(3, B, n)`` and
            ``(2, B, n)``.
        valid: ``(B,)`` bool, whether slot s serves a firing filter.

    Returns:
        ``(3, B, n)``: slot s's resampled rows at s, as
        :func:`resample_expand_seg` gives them.  Only the valid slots'
        rows are written.
    """
    global expand_compressed_seg_launch_count
    device = vals.device
    if device.type == "cpu":
        return expand_compressed_seg_plain(vals, iv, valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = _launch_expand_compressed(vals, iv, valid, vals.shape[-1])
    expand_compressed_seg_launch_count += 1
    return out


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
           plain: bool) -> torch.Tensor:
    """Pass 2 of the merge from the boundaries: K3b, or K3c and K3d
    (their plain twins with ``plain``)."""
    if pass2 == "windowed":
        expand = resample_expand_plain if plain else resample_expand
        return expand(p_rows, t_hi, n)
    compact = compact_particles_plain if plain else compact_particles
    expand = expand_compressed_plain if plain else expand_compressed
    vals, iv, _ = compact(p_rows, t_hi)
    return expand(vals, iv, n)


def expand_seg(p_rows: torch.Tensor, t_hi: torch.Tensor, fids: torch.Tensor,
               valid: torch.Tensor, pass2: str = "windowed") -> torch.Tensor:
    """The wide filter's pass B in either form: :func:`resample_expand_seg`
    (``"windowed"``), or :func:`compact_particles_seg` and
    :func:`expand_compressed_seg` (``"compressed"``).  The valid slots'
    rows are equal bit for bit."""
    if pass2 == "windowed":
        return resample_expand_seg(p_rows, t_hi, fids, valid)
    vals, iv, _ = compact_particles_seg(p_rows, t_hi, fids, valid)
    return expand_compressed_seg(vals, iv, valid)


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
    wq, _, q_tot = quantize_weights(w_row)
    t_hi = resample_boundary_plain(wq, 1.0 / q_tot, _offs_on(offs, device), n)
    return _pass2(p_rows, t_hi, n, pass2, plain=True)


def merge_resample_rows(p_rows: torch.Tensor, w_row: torch.Tensor, n: int,
                        offs, *, device: torch.device | str,
                        pass2: str = "windowed") -> torch.Tensor:
    """Systematic resample of row-major particles.

    Selection is bit-identical to ``resample_indices(method="hist")`` on
    the same weights and offset; values are copied exactly.

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
    wq, base, q_tot = quantize_weights(w_row)
    t_hi = resample_boundary(wq, base, 1.0 / q_tot, _offs_on(offs, device), n)
    return _pass2(p_rows, t_hi, n, pass2, plain=False)
