"""The systematic merge resample: K3 as two CUDA kernels and their plain
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

Each kernel wrapper has its plain twin (:func:`resample_boundary_plain`,
:func:`resample_expand_plain`, :func:`resample_expand_seg_plain`) on the
same inputs, and
:func:`merge_resample_rows_plain` is the whole resample in plain torch:
quantize, boundaries, :func:`decode_indices`, gather.  Dispatch is by
device: a CPU tensor runs the plain twins; a CUDA tensor launches the
kernels or raises.

The TPU's scheduling machinery (bf16 splits and one-hot matmuls, skip
tables, static caps and the XLA fallback behind them) is not ported:
every weight profile takes the same two launches.
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

#: Lanes per boundary block: the kernel's ``kScanBlock``.
BLOCK = 1024
_MAX_N = 1 << 24  # boundaries and integer prefixes exact in float32


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
                              n: int, offs, *,
                              device: torch.device | str) -> torch.Tensor:
    """The resample in plain torch, on any device: quantize, boundaries,
    :func:`decode_indices`, gather.  Same arguments and return as
    :func:`merge_resample_rows`."""
    device = _build.resolve_device(device)
    _check_rows(p_rows, w_row, n, device)
    wq, _, q_tot = quantize_weights(w_row)
    t_hi = resample_boundary_plain(wq, 1.0 / q_tot, _offs_on(offs, device), n)
    return resample_expand_plain(p_rows, t_hi, n)


def merge_resample_rows(p_rows: torch.Tensor, w_row: torch.Tensor, n: int,
                        offs, *, device: torch.device | str) -> torch.Tensor:
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
            launches the two kernels, the CPU runs
            :func:`merge_resample_rows_plain`.

    Returns:
        ``(3, n_pad)`` resampled rows, padding lanes zero.
    """
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return merge_resample_rows_plain(p_rows, w_row, n, offs,
                                         device=device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _build.cuda_library(device)
    _check_rows(p_rows, w_row, n, device)
    wq, base, q_tot = quantize_weights(w_row)
    t_hi = resample_boundary(wq, base, 1.0 / q_tot, _offs_on(offs, device), n)
    return resample_expand(p_rows, t_hi, n)
