"""The batched and the wide particle filters: K4, K5a, K5b (and the
segmented K3b of :mod:`~tpuslam_torch.ops.resample_cuda`) as CUDA kernels
beside their plain twins, and the two rollouts built on them.

Port of ``tpuslam/ops/pf_batch_pallas.py``: B independent filters of the
reference's scale advance in lockstep, the Monte-Carlo sweep shape.

* **Batched** (:func:`pf_batch_rollout`): one launch of
  ``csrc/pf_batch.cu`` (K4) a step does the whole step of every filter:
  the ESS gate from the carried normalizers, the quantized systematic
  resample where it fires, predict, the landmark log-likelihood and the
  filter's new normalizers and MAP particle.  Up to 8192 particles a
  filter.
* **Wide** (:func:`pf_batch_wide_rollout`): filters of any size up to
  ``2**24`` particles.  A step is the ESS gate of the carried
  normalizers (which K5b of the step before writes beside them; the
  first step's, and a lone :func:`pf_batch_wide_step`'s, in torch,
  ``(B,)`` ops only), then K5a (the slot compaction of the firing
  filters, their quantized weights, prefixes and boundaries, one block a
  filter, ``csrc/pf_wide.cu``), the segmented K3b (the copies,
  ``csrc/resample.cu``) and K5b (predict, weight and each filter's
  normalizers and MAP particle, reduced inside the kernel: one
  1024-thread block a filter; ``csrc/pf_wide.cu``).  With
  ``pass2="compressed"`` the segmented K3c and K3d take the segmented
  K3b's place, bit for bit.

Layouts: particles ``(3, B, n)`` rows x, y, yaw (filter f's particles
contiguous), log weights ``(B, n)``, per-filter normalizers ``(B,)``; the
JAX package's sublane packing and padding lanes are not ported
(:mod:`tpuslam_torch.convert` reads and writes its layout).  The two
paths keep the JAX package's two weight conventions: after a resample the
batched filter's log weights restart at ``-log n`` (normalized), the wide
filter's at 0 (unnormalized, with ``lse = log n`` at init).

Dispatch is by device: a CPU tensor runs the plain twins; a CUDA tensor
launches the kernels or raises.  The ``*_plain`` twins of the kernel
wrappers run on any device; they repeat the kernels' arithmetic (and,
with Philox noise, their random bits) and differ only by rounding (FMA
contraction, the order of sums).  Selection is bit-equal where the twin and the kernel
share the quantized integers and the offsets.

Noise: Philox4x32-10 keyed by the step's seed; particle ``j`` of filter
``f`` draws its three normals from the counter ``(j, f, 0, 0)``, and K4
its comb offset from ``(0, f, 1, 0)``.  Every wrapper takes injected
``(3, B, n)`` normals and ``(B,)`` offsets instead.  The observation
noise and the wide path's comb offsets come from a ``torch.Generator`` on
the rollout's device, or from the caller.  The seeds follow the JAX
rollouts: ``1``, then ``+7919`` a step (batched) or
``+max(7919, B * ceil(n / 1024))`` (wide).

K4 and K5b take one plan per ``(cfg, device)``; a call passes its seed's
words (and K5b its batch) to the library's entry.

Spans (:func:`~tpuslam_torch.utils.profiling.span`, recorded only while a
profiler records): :func:`pf_batch_rollout` records
``tpuslam.pf_batch.rollout`` around the call, ``tpuslam.pf_batch.prepare``
from its start to the step loop and ``tpuslam.pf_batch.step`` around each
step, one K4 launch.  :func:`pf_batch_wide_rollout` records
``tpuslam.pf_wide.rollout``, ``.prepare`` and ``.step`` in the same way;
inside each step, ``tpuslam.pf_wide.resample`` holds K5a and the
segmented expand (or the segmented K3c and K3d under
``pass2="compressed"``), after the gate and before K5b.  A wide step is
one launch of each form it uses (``_build.launches``: ``wide_boundary``,
``resample_expand_seg`` or ``compact_seg`` and ``expand_compressed_seg``,
``wide_stats``).

Host synchronisation: none a step.  The gate, the slot compaction and the
kernels' arguments stay on the device, and no wrapper reads a device
value on the host (``utils/profiling.py::count_host_syncs`` counts what
torch reports).
"""

from __future__ import annotations

import ctypes
import math
import typing

import torch

from tpuslam_torch.filters.pf import (PfConfig, boundary_law,
                                      check_generator, decode_slots,
                                      quantize_weights_law)
from tpuslam_torch.models.process import circular_step
from tpuslam_torch.ops import _build, pf_cuda, resample_cuda
from tpuslam_torch.ops._build import MODE_PHILOX
from tpuslam_torch.ops.fastmath import philox4x32
from tpuslam_torch.ops.pf_cuda import (SEED0, SEED_STEP, _constants,
                                       _observe, _predict_loglik,
                                       _truth_tables)
from tpuslam_torch.utils.profiling import span

#: The JAX wide path's default resample tile, which sets its seed stride.
WIDE_TILE = 1024

_MAX_BATCH_N = 8192  # K4's kMaxN: shared memory holds 20 bytes a particle
_MAX_GRID_Y = 65535  # filters (wide) or slots a launch
_QUANTUM = float(1 << 20)
#: K5a's kBoundThreads: threads a block, each taking four consecutive
#: lanes of every tile of ``4 * _BOUND_THREADS``; sets its row-sum order.
_BOUND_THREADS = 512

_F32 = [("vdt", ctypes.c_float), ("wdt", ctypes.c_float),
        ("q0", ctypes.c_float), ("q1", ctypes.c_float),
        ("q2", ctypes.c_float), ("sx", ctypes.c_float),
        ("sy", ctypes.c_float), ("inv_sx", ctypes.c_float),
        ("inv_sy", ctypes.c_float), ("log_norm", ctypes.c_float)]
_LM = [("lm", ctypes.c_float * (2 * pf_cuda._MAX_LANDMARKS))]


class _PfBatchParams(ctypes.Structure):
    """Mirror of ``PfBatchParams`` in ``csrc/pf_batch.cu``."""

    _fields_ = [("n", ctypes.c_int), ("n_lm", ctypes.c_int),
                ("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)] + _F32 + [
        ("neg_log_n", ctypes.c_float), ("ess_min", ctypes.c_float)] + _LM


class _PfBatchBuffers(ctypes.Structure):
    """Mirror of ``PfBatchBuffers`` in ``csrc/pf_batch.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "p_in", "lw_in", "lse_in", "lse2_in", "z", "normals", "offs",
        "p_out", "lw_out", "lse_out", "lse2_out", "est_out", "ess_out",
        "fire_out", "bad_out", "sel_out")]


class _WideParams(ctypes.Structure):
    """Mirror of ``WideParams`` in ``csrc/pf_wide.cu``."""

    _fields_ = [("n", ctypes.c_int), ("b", ctypes.c_int),
                ("n_lm", ctypes.c_int), ("key0", ctypes.c_uint32),
                ("key1", ctypes.c_uint32)] + _F32 + [
        ("ess_min", ctypes.c_float)] + _LM


class _WideBuffers(ctypes.Structure):
    """Mirror of ``WideBuffers`` in ``csrc/pf_wide.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "p_in", "lw_in", "z", "normals", "bad", "fire", "src", "expanded",
        "p_out", "lw_out", "lse_out", "lse2_out", "est_out", "gate_bad",
        "gate_ess", "gate_fire")]


class PfBatchState(typing.NamedTuple):
    """Carried state of the batched filters.

    The truth trajectory is shared (the circular process is
    deterministic); only the observation noise differs per filter.
    ``lse``/``lse2`` are the carried normalizers the gate reads: a state
    built by hand must keep them consistent with ``log_w``
    (:func:`pf_batch_refresh_stats`).
    """

    x_true: torch.Tensor  # (3,)
    particles: torch.Tensor  # (3, B, n)
    log_w: torch.Tensor  # (B, n) unnormalized
    lse: torch.Tensor  # (B,) logsumexp(log_w)
    lse2: torch.Tensor  # (B,) logsumexp(2 log_w)


class PfBatchOut(typing.NamedTuple):
    x_true: torch.Tensor  # (3,)
    x_est: torch.Tensor  # (B, 3) per-filter MAP estimate
    ess: torch.Tensor  # (B,) pre-resample ESS (the gate value)
    lse: torch.Tensor  # (B,) logsumexp of the updated log weights
    resampled: torch.Tensor  # (B,) bool
    bad: torch.Tensor  # (B,) bool: the NaN/-inf reset fired


class PfBatchRows(typing.NamedTuple):
    """What one K4 launch writes (and its twin returns)."""

    particles: torch.Tensor  # (3, B, n)
    log_w: torch.Tensor  # (B, n)
    lse: torch.Tensor  # (B,)
    lse2: torch.Tensor  # (B,)
    x_est: torch.Tensor  # (B, 3)
    ess: torch.Tensor  # (B,)
    resampled: torch.Tensor  # (B,) bool
    bad: torch.Tensor  # (B,) bool
    sel: torch.Tensor | None  # (B, n) int32 source of each slot, on request


class PfBatchWideState(typing.NamedTuple):
    """Carried state of the wide filters: :class:`PfBatchState`'s fields
    plus the last estimate."""

    x_true: torch.Tensor  # (3,)
    particles: torch.Tensor  # (3, B, n)
    log_w: torch.Tensor  # (B, n) unnormalized
    lse: torch.Tensor  # (B,)
    lse2: torch.Tensor  # (B,)
    x_est: torch.Tensor  # (B, 3)


class WideSlots(typing.NamedTuple):
    """What K5a writes for one step: the slot compaction of the firing
    filters and their boundaries."""

    fids: torch.Tensor  # (B,) int32: slot s's filter (0 past the firing)
    valid: torch.Tensor  # (B,) bool: slot s serves a firing filter
    src: torch.Tensor  # (B,) int32: filter f's slot (clipped)
    t_hi: torch.Tensor  # (B, n) int32 boundaries, slot order (valid rows)


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------

def _check_common(cfg: PfConfig, particles, log_w, z, normals, device,
                  max_n: int) -> tuple[int, int]:
    n = cfg.num_particles
    if not 1 <= n <= max_n:
        raise ValueError(f"num_particles {n} must be in [1, {max_n}]")
    if not 0 <= len(cfg.landmarks) <= pf_cuda._MAX_LANDMARKS:
        raise ValueError(f"at most {pf_cuda._MAX_LANDMARKS} landmarks")
    if log_w.dim() != 2:
        raise ValueError(f"log_w must be (B, n), got {tuple(log_w.shape)}")
    b = log_w.shape[0]
    if not 1 <= b <= _MAX_GRID_Y:
        raise ValueError(f"batch {b} must be in [1, {_MAX_GRID_Y}]")
    want = {"particles": (particles, (3, b, n)), "log_w": (log_w, (b, n)),
            "z": (z, (b, len(cfg.landmarks), 2))}
    if normals is not None:
        want["normals"] = (normals, (3, b, n))
    for name, (t, shape) in want.items():
        _build.check_tensor(name, t, shape, torch.float32, device)
    return b, n


# ---------------------------------------------------------------------------
# K4: the batched step.
# ---------------------------------------------------------------------------

def _batch_rows(b: int, n: int, device: torch.device,
                with_sel: bool) -> PfBatchRows:
    f32 = dict(dtype=torch.float32, device=device)
    return PfBatchRows(
        particles=torch.empty((3, b, n), **f32),
        log_w=torch.empty((b, n), **f32), lse=torch.empty(b, **f32),
        lse2=torch.empty(b, **f32), x_est=torch.empty((b, 3), **f32),
        ess=torch.empty(b, **f32),
        resampled=torch.empty(b, dtype=torch.bool, device=device),
        bad=torch.empty(b, dtype=torch.bool, device=device),
        sel=(torch.empty((b, n), dtype=torch.int32, device=device)
             if with_sel else None))


def _check_batch(cfg, particles, log_w, lse, lse2, z, normals, offs,
                 out) -> tuple[int, int]:
    device = log_w.device
    b, n = _check_common(cfg, particles, log_w, z, normals, device,
                         _MAX_BATCH_N)
    vec = {"lse": lse, "lse2": lse2}
    if offs is not None:
        vec["offs"] = offs
    for name, t in vec.items():
        _build.check_tensor(name, t, (b,), torch.float32, device)
    if out is not None:
        for name, t in zip(PfBatchRows._fields, out):
            if t is None:
                continue
            shape = {"particles": (3, b, n), "log_w": (b, n),
                     "x_est": (b, 3), "sel": (b, n)}.get(name, (b,))
            dtype = {"resampled": torch.bool, "bad": torch.bool,
                     "sel": torch.int32}.get(name, torch.float32)
            _build.check_tensor(f"out.{name}", t, shape, dtype, device)
    return b, n


def _gate(cfg: PfConfig, lse: torch.Tensor, lse2: torch.Tensor):
    """``(bad, ess, fire)`` from the carried normalizers, on their
    device (the JAX package's XLA prelude, ``pf_batch_pallas.py:602-609``)."""
    n = cfg.num_particles
    bad = ~(torch.isfinite(lse) & torch.isfinite(lse2))
    ess = torch.where(bad, float(n), torch.exp(2.0 * lse - lse2))
    fire = ~bad & (ess < n * cfg.ess_threshold_frac)
    return bad, ess, fire


def _batch_offs(offs, mode: int, seed: int, b: int,
                device: torch.device) -> torch.Tensor:
    """K4's comb offsets: the caller's, else one Philox draw a filter
    (counter ``(0, f, 1, 0)``) with noise on, else 0.5."""
    if offs is not None:
        return offs
    if mode != MODE_PHILOX:
        return torch.full((b,), 0.5, dtype=torch.float32, device=device)
    filt = torch.arange(b, dtype=torch.int64, device=device)
    a0 = philox4x32(0, filt, 1, 0, *_build.seed_words(seed))[0]
    return (a0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _map_plain(p_rows: torch.Tensor, lw: torch.Tensor):
    """``(lse, lse2, x_est)`` of ``(B, n)`` log weights: the maximum over
    the non-NaN lanes, the MAP particle the highest index among the
    maxima."""
    key = torch.where(torch.isnan(lw), float("-inf"), lw)
    m = key.max(dim=-1).values
    idx = torch.arange(lw.shape[-1], device=lw.device)
    best = torch.where(key == m[:, None], idx, -1).max(dim=-1).values
    shift = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(lw - shift[:, None])
    est = torch.take_along_dim(p_rows, best[None, :, None], dim=2)[..., 0]
    return (m + torch.log(e.sum(dim=-1)),
            2.0 * m + torch.log((e * e).sum(dim=-1)), est.T)


def pf_batch_step_rows_plain(cfg: PfConfig, seed: int,
                             particles: torch.Tensor, log_w: torch.Tensor,
                             lse: torch.Tensor, lse2: torch.Tensor,
                             z: torch.Tensor, noise_on: bool = True,
                             normals: torch.Tensor | None = None,
                             offs: torch.Tensor | None = None, *,
                             out: PfBatchRows | None = None,
                             with_sel: bool = False) -> PfBatchRows:
    """Plain twin of :func:`pf_batch_step_rows`, on any device."""
    mode = _build.noise_mode(noise_on, normals)
    b, n = _check_batch(cfg, particles, log_w, lse, lse2, z, normals, offs,
                        out)
    device = log_w.device
    bad, ess, fire = _gate(cfg, lse, lse2)
    offs = _batch_offs(offs, mode, seed, b, device)
    neg_log_n = -math.log(float(n))
    lw_norm = torch.where(bad[:, None], neg_log_n, log_w - lse[:, None])

    # The resample of every firing filter (the others decode a uniform
    # row and keep their own particles).
    w = torch.where(fire[:, None], torch.exp(log_w - lse[:, None]), 1.0)
    cum = torch.cumsum(torch.round(w * _QUANTUM), dim=-1)  # exact integers
    inv_tot = 1.0 / cum[:, -1:]
    t = torch.clamp(boundary_law(cum, inv_tot, n, offs[:, None]), 0, n)
    t = t.to(torch.int64)
    t[:, n - 1:] = n
    lane = torch.arange(n, device=device)
    src = torch.where(fire[:, None], decode_slots(t), lane)
    p_sel = torch.take_along_dim(particles, src[None], dim=2)
    lw_cur = torch.where(fire[:, None], neg_log_n, lw_norm)

    x, y, yaw, acc = _predict_loglik(cfg, z, p_sel[0], p_sel[1], p_sel[2],
                                     mode, normals, int(seed))
    p_new = torch.stack([x, y, yaw])
    lw_new = lw_cur + acc
    lse_new, lse2_new, x_est = _map_plain(p_new, lw_new)
    rows = PfBatchRows(p_new, lw_new, lse_new, lse2_new, x_est, ess, fire,
                       bad, src.to(torch.int32) if with_sel else None)
    if out is None:
        return rows
    for dst, value in zip(out, rows):
        if dst is not None:
            dst.copy_(value)
    return out


def pf_batch_step_rows(cfg: PfConfig, seed: int, particles: torch.Tensor,
                       log_w: torch.Tensor, lse: torch.Tensor,
                       lse2: torch.Tensor, z: torch.Tensor,
                       noise_on: bool = True,
                       normals: torch.Tensor | None = None,
                       offs: torch.Tensor | None = None, *,
                       out: PfBatchRows | None = None,
                       with_sel: bool = False) -> PfBatchRows:
    """K4: one step of every filter in one kernel launch.

    Args:
        seed: key of the kernel's Philox stream.
        particles: ``(3, B, n)``; log_w: ``(B, n)``; lse, lse2: ``(B,)``
            the carried normalizers the gate reads.
        z: ``(B, L, 2)`` each filter's robot-frame observation.
        normals: optional ``(3, B, n)`` standard normals in place of the
            Philox stream (noise on only).
        offs: optional ``(B,)`` comb offsets in [0, 1) in place of the
            Philox draw (or of 0.5 with noise off).
        out: optional preallocated rows to write (a rollout's step
            slices); fresh ones otherwise.
        with_sel: also write each slot's source particle (``sel``).

    A CPU tensor runs :func:`pf_batch_step_rows_plain`.
    """
    device = log_w.device
    if device.type == "cpu":
        return pf_batch_step_rows_plain(cfg, seed, particles, log_w, lse,
                                        lse2, z, noise_on, normals, offs,
                                        out=out, with_sel=with_sel)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    mode = _build.noise_mode(noise_on, normals)
    b, n = _check_batch(cfg, particles, log_w, lse, lse2, z, normals, offs,
                        out)
    if out is None:
        out = _batch_rows(b, n, device, with_sel)
    return _launch_batch(cfg, seed, particles, log_w, lse, lse2, z, mode,
                         normals, offs, out)


def _batch_plan(cfg: PfConfig, device: torch.device) -> _build.Plan:
    """K4's launch plan for ``(cfg, device)``, built at its first launch:
    the parameters from ``pf_cuda._constants``, ``-log n`` and the gate's
    threshold, their key left 0 for the entry to set."""
    n = cfg.num_particles
    return _build.plan(
        ("pf_batch_step", cfg, device), device, "tpuslam_pf_batch_step",
        lambda: _PfBatchParams(n=n, n_lm=len(cfg.landmarks),
                               neg_log_n=-math.log(float(n)),
                               ess_min=n * cfg.ess_threshold_frac,
                               **_constants(cfg)))


def _launch_batch(cfg: PfConfig, seed: int, particles: torch.Tensor,
                  log_w: torch.Tensor, lse: torch.Tensor, lse2: torch.Tensor,
                  z: torch.Tensor, mode: int, normals: torch.Tensor | None,
                  offs: torch.Tensor | None, out: PfBatchRows) -> PfBatchRows:
    """K4's launch on checked arguments, into ``out``."""
    plan = _batch_plan(cfg, log_w.device)
    ptr = _build.ptr
    bufs = _PfBatchBuffers(
        p_in=particles.data_ptr(), lw_in=log_w.data_ptr(),
        lse_in=lse.data_ptr(), lse2_in=lse2.data_ptr(), z=z.data_ptr(),
        normals=ptr(normals), offs=ptr(offs),
        p_out=out.particles.data_ptr(), lw_out=out.log_w.data_ptr(),
        lse_out=out.lse.data_ptr(), lse2_out=out.lse2.data_ptr(),
        est_out=out.x_est.data_ptr(), ess_out=out.ess.data_ptr(),
        fire_out=out.resampled.data_ptr(), bad_out=out.bad.data_ptr(),
        sel_out=ptr(out.sel))
    _build.launch("pf_batch_step", plan.entry, plan.index,
                  ctypes.addressof(bufs), plan.params_ptr,
                  *_build.seed_words(seed), log_w.shape[0], mode)
    return out


def div_by_const(a: torch.Tensor, s: float, *,
                 law_only: bool) -> torch.Tensor:
    """``a / s`` in float32 on a CUDA device, as K2b, K4 and K5b take
    their landmark quotients: ``pf_math.cuh::div_by_const`` on the host's
    float32 ``1 / s`` where the divisor and the operand lie in its exact
    range, the IEEE divide elsewhere; with ``law_only``,
    ``div_by_const`` everywhere.  A check of the law on the card (the
    library's ``tpuslam_div_by_const``); no path calls it."""
    if a.device.type != "cuda":
        raise ValueError(f"div_by_const runs on a CUDA device, not {a.device}")
    _build.check_tensor("a", a, (a.numel(),), torch.float32, a.device)
    q = torch.empty_like(a)
    entry = _build.cuda_library(a.device).tpuslam_div_by_const
    _build.launch("div_by_const", entry, a.device.index, a.data_ptr(),
                  q.data_ptr(), a.numel(), s, pf_cuda.recip32(s),
                  int(law_only))
    return q


def pf_batch_init(cfg: PfConfig, batch: int, *,
                  device: torch.device | str) -> PfBatchState:
    """All filters at x0 with uniform weights (particle_filter.py:77-84):
    log weights ``-log n``, ``lse = 0``, ``lse2 = -log n``."""
    device = _build.resolve_device(device)
    n = cfg.num_particles
    f32 = dict(dtype=torch.float32, device=device)
    particles = torch.empty((3, batch, n), **f32)
    for row, value in zip(particles, cfg.x0):
        row.fill_(value)
    neg_log_n = -math.log(float(n))
    return PfBatchState(
        x_true=_build.device_constant(cfg.x0, particles),
        particles=particles, log_w=torch.full((batch, n), neg_log_n, **f32),
        lse=torch.zeros(batch, **f32),
        lse2=torch.full((batch,), neg_log_n, **f32))


def pf_batch_refresh_stats(cfg: PfConfig, state):
    """Recompute the carried ``lse``/``lse2`` from ``log_w`` (for states
    assembled by hand: the gate reads the carried normalizers).  Works on
    :class:`PfBatchState` and :class:`PfBatchWideState`."""
    lw = state.log_w
    m = lw.max(dim=-1).values
    e = torch.exp(lw - torch.where(torch.isfinite(m), m, 0.0)[:, None])
    return state._replace(lse=m + torch.log(e.sum(dim=-1)),
                          lse2=2.0 * m + torch.log((e * e).sum(dim=-1)))


def _rollout_device(generator: torch.Generator | None,
                    device: torch.device | str) -> torch.device:
    if generator is not None:
        device = check_generator(generator, device)
    return _build.resolve_device(device)


def _draw(generator, shape: tuple, given, device: torch.device, what: str,
          uniform: bool = False) -> torch.Tensor:
    """The caller's ``given`` as float32 of ``shape`` on ``device``, or a
    draw from ``generator`` (uniform in [0, 1), or standard normal)."""
    f32 = dict(dtype=torch.float32, device=device)
    if given is not None:
        return torch.as_tensor(given, **f32).reshape(shape).contiguous()
    if generator is None:
        raise ValueError(f"no generator to draw the {what} from, and none "
                         "given")
    draw = torch.rand if uniform else torch.randn
    return draw(shape, generator=generator, **f32)


def _obs_noise(cfg, generator, lead: tuple, given, device) -> torch.Tensor:
    """Scaled observation noise ``lead + (L, 2)``: the caller's, or
    normals from ``generator`` times ``r_std`` (per filter)."""
    shape = lead + (len(cfg.landmarks), 2)
    if given is not None:
        return _draw(None, shape, given, device, "observation noise")
    noise = _draw(generator, shape, None, device, "observation noise")
    return noise * _build.device_constant(cfg.r_std, noise)


def pf_batch_step(cfg: PfConfig, state: PfBatchState,
                  generator: torch.Generator | None, seed: int,
                  noise_on: bool = True, *, obs_noise=None, offs=None,
                  normals: torch.Tensor | None = None):
    """One step of B independent filters (main_pf order: resample ->
    predict -> observe -> weight -> estimate; the shared truth advances
    first), one K4 launch on a CUDA state.

    Args:
        generator: draws the observation noise (on the state's device)
            where ``obs_noise`` is not given.
        seed: key of the kernel's Philox stream.
        obs_noise: optional ``(B, L, 2)`` scaled observation noise.
        offs: optional ``(B,)`` comb offsets.
        normals: optional ``(3, B, n)`` standard normals (noise on).

    Returns:
        ``(next_state, PfBatchOut)``.
    """
    device = state.log_w.device
    b = state.log_w.shape[0]
    noise = _obs_noise(cfg, generator, (b,), obs_noise, device)
    x_true = circular_step(state.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)
    z = (_observe(cfg, x_true) + noise).contiguous()
    if offs is not None:
        offs = _draw(None, (b,), offs, device, "offsets")
    rows = pf_batch_step_rows(cfg, seed, state.particles, state.log_w,
                              state.lse, state.lse2, z, noise_on, normals,
                              offs)
    return (PfBatchState(x_true, rows.particles, rows.log_w, rows.lse,
                         rows.lse2),
            PfBatchOut(x_true, rows.x_est, rows.ess, rows.lse,
                       rows.resampled, rows.bad))


def pf_batch_rollout(cfg: PfConfig, generator: torch.Generator | None,
                     batch: int, n_steps: int, noise_on: bool = True, *,
                     device: torch.device | str,
                     state0: PfBatchState | None = None, obs_noise=None,
                     offs=None):
    """``n_steps`` batched steps, one K4 launch each and no host sync
    (the path of ``bench.py``'s ``bench_pf_batch``).

    Args:
        generator: draws the observation noise where ``obs_noise`` is not
            given; on ``device``.
        batch: filters (from :func:`pf_batch_init`, unless ``state0``).
        device: required; a CUDA device launches K4, the CPU runs the
            plain twin.
        obs_noise: optional ``(n_steps, B, L, 2)`` scaled observation
            noise.
        offs: optional ``(n_steps, B)`` comb offsets in place of the
            kernel's Philox draw.

    Returns:
        ``(final_state, outs)``: ``outs`` stacks :class:`PfBatchOut` over
        steps (``x_true (T, 3)``, ``x_est (T, B, 3)``, ``ess (T, B)``,
        ...).
    """
    with span("tpuslam.pf_batch.rollout"):
        with span("tpuslam.pf_batch.prepare"):
            device = _rollout_device(generator, device)
            if n_steps < 1:
                raise ValueError(f"n_steps {n_steps} must be positive")
            if device.type == "cuda":
                _build.cuda_library(device)
            state = pf_batch_init(cfg, batch, device=device) \
                if state0 is None else state0
            b, n = state.log_w.shape
            x_tbl, z_clean = _truth_tables(cfg, state, n_steps,
                                           state0 is None)
            noise = _obs_noise(cfg, generator, (n_steps, b), obs_noise,
                               device)
            z_all = (z_clean[:, None] + noise).contiguous()  # (T, B, L, 2)
            if offs is not None:
                offs = _draw(None, (n_steps, b), offs, device, "offsets")
            # Every step writes its outputs straight into the stacked
            # buffers, and the particles and log weights alternate between
            # two buffers: a step is one launch and nothing else.
            f32 = dict(dtype=torch.float32, device=device)
            b_rows = dict(dtype=torch.bool, device=device)
            outs = PfBatchRows(
                particles=None, log_w=None,
                lse=torch.empty((n_steps, b), **f32),
                lse2=torch.empty((n_steps, b), **f32),
                x_est=torch.empty((n_steps, b, 3), **f32),
                ess=torch.empty((n_steps, b), **f32),
                resampled=torch.empty((n_steps, b), **b_rows),
                bad=torch.empty((n_steps, b), **b_rows), sel=None)
            bufs = [(torch.empty((3, b, n), **f32),
                     torch.empty((b, n), **f32)) for _ in range(2)]
            p, lw = state.particles, state.log_w
            lse, lse2 = state.lse, state.lse2
            seed = SEED0
        for k in range(n_steps):
            with span("tpuslam.pf_batch.step"):
                p_out, lw_out = bufs[k % 2]
                row = PfBatchRows(p_out, lw_out,
                                  *(t[k] for t in outs[2:8]), None)
                pf_batch_step_rows(cfg, seed, p, lw, lse, lse2, z_all[k],
                                   noise_on, None,
                                   None if offs is None else offs[k],
                                   out=row)
                p, lw, lse, lse2 = p_out, lw_out, row.lse, row.lse2
                seed += SEED_STEP
        final = PfBatchState(x_tbl[-1], p, lw, lse, lse2)
        return final, PfBatchOut(x_tbl, outs.x_est, outs.ess, outs.lse,
                                 outs.resampled, outs.bad)


# ---------------------------------------------------------------------------
# The wide filters: K5a, the segmented K3b, K5b.
# ---------------------------------------------------------------------------

def wide_seed_step(cfg: PfConfig, batch: int) -> int:
    """The wide rollout's seed advance, ``max(7919, B * W)`` with W the
    JAX package's resample tiles a filter (``pf_batch_pallas.py:1566``)."""
    return max(SEED_STEP, batch * -(-cfg.num_particles // WIDE_TILE))


def pf_batch_wide_init(cfg: PfConfig, batch: int, *,
                       device: torch.device | str) -> PfBatchWideState:
    """All filters at x0 with uniform weights: log weights 0,
    ``lse = lse2 = log n`` (the wide path's unnormalized convention)."""
    st = pf_batch_init(cfg, batch, device=device)
    log_n = math.log(float(st.log_w.shape[1]))
    return PfBatchWideState(
        x_true=st.x_true, particles=st.particles,
        log_w=torch.zeros_like(st.log_w), lse=torch.full_like(st.lse, log_n),
        lse2=torch.full_like(st.lse, log_n),
        x_est=st.x_true.expand(batch, 3).contiguous())


def _slots_plain(fire: torch.Tensor):
    """``(fids, valid, src)`` of the firing filters compacted into slots
    in filter order (slot ``s < n_fire`` serves the s-th firing filter),
    on the device and without a host read."""
    b = fire.shape[0]
    fire_i = fire.to(torch.int32)
    pos = torch.cumsum(fire_i, dim=0, dtype=torch.int32) - fire_i
    tgt = torch.where(fire, pos, b).to(torch.int64)  # b: dropped
    ids = torch.arange(b, dtype=torch.int32, device=fire.device)
    fids = torch.zeros(b + 1, dtype=torch.int32, device=fire.device)
    fids = fids.scatter_(0, tgt, ids)[:b]
    return fids, ids < fire_i.sum(), pos.clamp(0, b - 1)


def wide_row_total_plain(w: torch.Tensor) -> torch.Tensor:
    """Each row's sum of ``(R, n)`` float32 weights in K5a's order: lane j
    goes to thread ``(j mod 4T) // 4`` of ``T = _BOUND_THREADS``, each
    thread adds its lanes in sequence from 0 (tile by tile, four lanes a
    tile), then a tree of halving adds over the threads (level h:
    ``v[i] + v[i + h]``).  Every add is one IEEE float32 add, as the
    kernel's ``__fadd_rn``."""
    r, n = w.shape
    span = 4 * _BOUND_THREADS
    k = -(-n // span)
    lanes = torch.nn.functional.pad(w, (0, k * span - n)).view(
        r, k, _BOUND_THREADS, 4).transpose(1, 2).reshape(
        r, _BOUND_THREADS, 4 * k)
    acc = torch.zeros((r, _BOUND_THREADS), dtype=w.dtype, device=w.device)
    for i in range(4 * k):
        acc = acc + lanes[..., i]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def wide_prefix_plain(log_w: torch.Tensor, lse: torch.Tensor):
    """K5a's quantized prefix of ``(R, n)`` log weights with their
    ``(R,)`` normalizers: ``w = exp(lw - lse)`` quantized by
    :func:`~tpuslam_torch.filters.pf.quantize_weights_law` of its
    :func:`wide_row_total_plain` row sum, the inclusive prefix (exact
    integers below ``2**24``) and ``inv_tot = 1 / q_tot``.  Returns
    ``(cum, inv_tot)``."""
    w = torch.exp(log_w - lse[:, None])
    wq = quantize_weights_law(w, wide_row_total_plain(w)[:, None])
    cum = torch.cumsum(wq, dim=-1)
    return cum, 1.0 / cum[:, -1]


def _check_boundary(log_w, lse, fire, offs) -> tuple[int, int]:
    device = log_w.device
    if log_w.dim() != 2:
        raise ValueError(f"log_w must be (B, n), got {tuple(log_w.shape)}")
    b, n = log_w.shape
    if not 1 <= n < _build.MAX_N or not 1 <= b <= _MAX_GRID_Y:
        raise ValueError(f"(B, n) = {(b, n)} out of range")
    _build.check_tensor("log_w", log_w, (b, n), torch.float32, device)
    _build.check_tensor("lse", lse, (b,), torch.float32, device)
    _build.check_tensor("fire", fire, (b,), torch.bool, device)
    _build.check_tensor("offs", offs, (b,), torch.float32, device)
    return b, n


def wide_boundary_plain(log_w: torch.Tensor, lse: torch.Tensor,
                        fire: torch.Tensor, offs: torch.Tensor) -> WideSlots:
    """Plain twin of :func:`wide_boundary`, on any device: the rows are
    gathered in slot order, quantized as K5a does (:func:`wide_prefix_plain`)
    and decoded by :func:`~tpuslam_torch.filters.pf.boundary_law`; idle
    slots' rows are 0."""
    b, n = _check_boundary(log_w, lse, fire, offs)
    fids, valid, src = _slots_plain(fire)
    sel = fids.to(torch.int64)
    cum, inv_tot = wide_prefix_plain(log_w[sel], lse[sel])
    t = torch.clamp(boundary_law(cum, inv_tot[:, None], n,
                                 offs[sel][:, None]), 0, n).to(torch.int32)
    t[:, n - 1:] = n
    return WideSlots(fids, valid, src, torch.where(valid[:, None], t, 0))


def wide_boundary(log_w: torch.Tensor, lse: torch.Tensor, fire: torch.Tensor,
                  offs: torch.Tensor) -> WideSlots:
    """K5a: the wide resample's prerequisites, one launch: the slot
    compaction of the firing filters, and each firing filter's weights
    ``exp(lw - lse)`` quantized (``quantize_weights_law`` of their row sum
    in the kernel's fixed order), prefixed and decoded into its slot
    boundaries.  Filters that do not fire cost a read of the gate.

    Args:
        log_w: ``(B, n)`` log weights; lse: ``(B,)`` their normalizers;
            fire: ``(B,)`` bool, the filters that resample; offs: ``(B,)``
            comb offsets in [0, 1); all in filter order.

    Returns:
        :class:`WideSlots`: ``t_hi`` ``(B, n)`` int32 in slot order
        (:func:`~tpuslam_torch.ops.resample_cuda.slot_boundaries`' law and
        forcing; only the valid slots' rows are written).  A CPU tensor
        runs :func:`wide_boundary_plain`.
    """
    device = log_w.device
    if device.type == "cpu":
        return wide_boundary_plain(log_w, lse, fire, offs)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b, n = _check_boundary(log_w, lse, fire, offs)
    i32 = dict(dtype=torch.int32, device=device)
    out = WideSlots(fids=torch.empty(b, **i32),
                    valid=torch.empty(b, dtype=torch.bool, device=device),
                    src=torch.empty(b, **i32),
                    t_hi=torch.empty((b, n), **i32))
    _build.launch("wide_boundary",
                  _build.cuda_library(device).tpuslam_wide_boundary,
                  device.index, log_w.data_ptr(), lse.data_ptr(),
                  fire.data_ptr(), offs.data_ptr(), out.t_hi.data_ptr(),
                  out.fids.data_ptr(), out.valid.data_ptr(),
                  out.src.data_ptr(), n, b)
    return out


def _check_stats(cfg, particles, log_w, z, bad, fire, src, expanded,
                 normals) -> tuple[int, int]:
    device = log_w.device
    b, n = _check_common(cfg, particles, log_w, z, normals, device,
                         _build.MAX_N - 1)
    _build.check_tensor("bad", bad, (b,), torch.bool, device)
    _build.check_tensor("fire", fire, (b,), torch.bool, device)
    if (src is None) != (expanded is None):
        raise ValueError("src and expanded go together (the fused form)")
    if expanded is not None:
        _build.check_tensor("src", src, (b,), torch.int32, device)
        _build.check_tensor("expanded", expanded, (3, b, n), torch.float32,
                            device)
    return b, n


def wide_stats_rows_plain(cfg: PfConfig, seed: int, particles: torch.Tensor,
                          log_w: torch.Tensor, z: torch.Tensor,
                          bad: torch.Tensor, fire: torch.Tensor,
                          src: torch.Tensor | None = None,
                          expanded: torch.Tensor | None = None,
                          noise_on: bool = True,
                          normals: torch.Tensor | None = None):
    """Plain twin of :func:`wide_stats_rows`, on any device."""
    mode = _build.noise_mode(noise_on, normals)
    _check_stats(cfg, particles, log_w, z, bad, fire, src, expanded,
                 normals)
    lw0 = log_w
    if expanded is not None:
        taken = expanded[:, src.to(torch.int64)]
        particles = torch.where(fire[None, :, None], taken, particles)
        lw0 = torch.where(fire[:, None], 0.0, lw0)
    lw0 = torch.where((bad & ~fire)[:, None], 0.0, lw0)
    x, y, yaw, acc = _predict_loglik(cfg, z, particles[0], particles[1],
                                     particles[2], mode, normals, int(seed))
    p_new = torch.stack([x, y, yaw])
    lw = lw0 + acc
    out = (p_new, lw) + _map_plain(p_new, lw)
    return out + (_gate(cfg, out[2], out[3]),)


def wide_stats_rows(cfg: PfConfig, seed: int, particles: torch.Tensor,
                    log_w: torch.Tensor, z: torch.Tensor, bad: torch.Tensor,
                    fire: torch.Tensor, src: torch.Tensor | None = None,
                    expanded: torch.Tensor | None = None,
                    noise_on: bool = True,
                    normals: torch.Tensor | None = None):
    """K5b: predict, weight and each filter's normalizers and MAP
    particle, one launch.

    With ``src`` and ``expanded`` (the fused form, the main path's), a
    firing filter takes its particles from the expanded rows of its slot
    ``src[f]`` and restarts its log weights at 0; a filter that is bad and
    does not fire restarts at 0 in either form.

    Returns:
        ``(particles', log_w', lse, lse2, x_est, gate)``: ``lse`` and
        ``lse2`` the ``(B,)`` logsumexp of ``log_w'`` and of twice it,
        ``x_est`` the ``(B, 3)`` MAP particle (the highest index among the
        maxima; a NaN log weight never wins), ``gate`` the next step's ESS
        gate ``(bad, ess, fire)`` of those normalizers, as :func:`_gate`
        computes it, bit for bit: the kernel writes it from the values it
        writes ``lse`` and ``lse2`` from, so the next step needs no torch
        op.  A CPU tensor runs :func:`wide_stats_rows_plain`.
    """
    device = log_w.device
    if device.type == "cpu":
        return wide_stats_rows_plain(cfg, seed, particles, log_w, z, bad,
                                     fire, src, expanded, noise_on, normals)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    mode = _build.noise_mode(noise_on, normals)
    _check_stats(cfg, particles, log_w, z, bad, fire, src, expanded, normals)
    return _launch_wide_stats(cfg, seed, particles, log_w, z, bad, fire, src,
                              expanded, mode, normals)


def _wide_plan(cfg: PfConfig, device: torch.device) -> _build.Plan:
    """K5b's launch plan for ``(cfg, device)``, built at its first launch:
    the parameters from ``pf_cuda._constants`` and the gate's threshold,
    their key and batch left 0 for the entry to set."""
    n = cfg.num_particles
    return _build.plan(
        ("wide_stats", cfg, device), device, "tpuslam_wide_stats",
        lambda: _WideParams(n=n, n_lm=len(cfg.landmarks),
                            ess_min=n * cfg.ess_threshold_frac,
                            **_constants(cfg)))


def _launch_wide_stats(cfg: PfConfig, seed: int, particles: torch.Tensor,
                       log_w: torch.Tensor, z: torch.Tensor,
                       bad: torch.Tensor, fire: torch.Tensor,
                       src: torch.Tensor | None,
                       expanded: torch.Tensor | None, mode: int,
                       normals: torch.Tensor | None):
    """K5b's launch on checked arguments, into fresh outputs."""
    device = log_w.device
    plan = _wide_plan(cfg, device)
    b = log_w.shape[0]
    p_out = torch.empty_like(particles)
    lw_out = torch.empty_like(log_w)
    f32 = dict(dtype=torch.float32, device=device)
    lse, lse2 = torch.empty(b, **f32), torch.empty(b, **f32)
    x_est = torch.empty((b, 3), **f32)
    gate = (torch.empty(b, dtype=torch.bool, device=device),
            torch.empty(b, **f32),
            torch.empty(b, dtype=torch.bool, device=device))
    ptr = _build.ptr
    bufs = _WideBuffers(
        p_in=particles.data_ptr(), lw_in=log_w.data_ptr(), z=z.data_ptr(),
        normals=ptr(normals), bad=bad.data_ptr(), fire=fire.data_ptr(),
        src=ptr(src), expanded=ptr(expanded), p_out=p_out.data_ptr(),
        lw_out=lw_out.data_ptr(), lse_out=lse.data_ptr(),
        lse2_out=lse2.data_ptr(), est_out=x_est.data_ptr(),
        gate_bad=gate[0].data_ptr(), gate_ess=gate[1].data_ptr(),
        gate_fire=gate[2].data_ptr())
    _build.launch("wide_stats", plan.entry, plan.index,
                  ctypes.addressof(bufs), plan.params_ptr,
                  *_build.seed_words(seed), b, mode,
                  int(expanded is not None))
    return p_out, lw_out, lse, lse2, x_est, gate


def _wide_step_core(cfg, state, x_true, z, seed, offs, noise_on, normals,
                    pass2, gate):
    """One wide step from the step's truth and observation, on ``gate``,
    ``(bad, ess, fire)`` of the state's normalizers.  Returns
    ``(next_state, out, next_gate)``."""
    bad, ess, fire = gate
    with span("tpuslam.pf_wide.resample"):
        slots = wide_boundary(state.log_w, state.lse, fire, offs)
        expanded = resample_cuda.expand_seg(state.particles, slots.t_hi,
                                            slots.fids, slots.valid, pass2)
    p, lw, lse, lse2, x_est, next_gate = wide_stats_rows(
        cfg, seed, state.particles, state.log_w, z, bad, fire, slots.src,
        expanded, noise_on, normals)
    return (PfBatchWideState(x_true, p, lw, lse, lse2, x_est),
            PfBatchOut(x_true, x_est, ess, lse, fire, bad), next_gate)


def pf_batch_wide_step(cfg: PfConfig, state: PfBatchWideState,
                       generator: torch.Generator | None, seed: int,
                       noise_on: bool = True, *, obs_noise=None, offs=None,
                       normals: torch.Tensor | None = None,
                       pass2: str = "windowed"):
    """One step of B wide filters (main_pf order), every launch made
    whatever the gate says and no host sync.

    Args:
        generator: draws the observation noise and the comb offsets (on
            the state's device) where they are not given.
        seed: key of K5b's Philox stream.
        obs_noise: optional ``(B, L, 2)`` scaled observation noise.
        offs: optional ``(B,)`` comb offsets in [0, 1).
        normals: optional ``(3, B, n)`` standard normals (noise on).
        pass2: the resample's pass B: ``"windowed"`` (the segmented
            expand) or ``"compressed"`` (the segmented compaction and the
            segmented expand over its stack); the two give the same step
            bit for bit.

    Returns:
        ``(next_state, PfBatchOut)``.
    """
    resample_cuda.check_pass2(pass2)
    device = state.log_w.device
    b = state.log_w.shape[0]
    noise = _obs_noise(cfg, generator, (b,), obs_noise, device)
    offs = _draw(generator, (b,), offs, device, "offsets", uniform=True)
    x_true = circular_step(state.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)
    z = (_observe(cfg, x_true) + noise).contiguous()
    return _wide_step_core(cfg, state, x_true, z, seed, offs, noise_on,
                           normals, pass2,
                           _gate(cfg, state.lse, state.lse2))[:2]


def pf_batch_wide_rollout(cfg: PfConfig, generator: torch.Generator | None,
                          batch: int, n_steps: int, noise_on: bool = True, *,
                          device: torch.device | str,
                          state0: PfBatchWideState | None = None,
                          obs_noise=None, offs=None,
                          pass2: str = "windowed"):
    """``n_steps`` wide steps (the path of ``bench.py``'s
    ``bench_pf_batch_wide``), no host sync.

    Args:
        generator: draws the observation noise and the comb offsets where
            they are not given; on ``device``.
        device: required; a CUDA device launches the kernels, the CPU runs
            the plain twins.
        obs_noise: optional ``(n_steps, B, L, 2)`` scaled observation
            noise.
        offs: optional ``(n_steps, B)`` comb offsets.
        pass2: the resample's pass B, as in :func:`pf_batch_wide_step`.

    Returns:
        ``(final_state, outs)`` as :func:`pf_batch_rollout`'s.
    """
    with span("tpuslam.pf_wide.rollout"):
        with span("tpuslam.pf_wide.prepare"):
            resample_cuda.check_pass2(pass2)
            device = _rollout_device(generator, device)
            if n_steps < 1:
                raise ValueError(f"n_steps {n_steps} must be positive")
            if device.type == "cuda":
                _build.cuda_library(device)
            state = (pf_batch_wide_init(cfg, batch, device=device)
                     if state0 is None else state0)
            b = state.log_w.shape[0]
            x_tbl, z_clean = _truth_tables(cfg, state, n_steps,
                                           state0 is None)
            noise = _obs_noise(cfg, generator, (n_steps, b), obs_noise,
                               device)
            z_all = (z_clean[:, None] + noise).contiguous()
            offs = _draw(generator, (n_steps, b), offs, device, "offsets",
                         uniform=True)
            seed, stride = SEED0, wide_seed_step(cfg, b)
            gate = _gate(cfg, state.lse, state.lse2)
            outs = []
        for k in range(n_steps):
            with span("tpuslam.pf_wide.step"):
                state, out, gate = _wide_step_core(
                    cfg, state, x_tbl[k], z_all[k], seed, offs[k], noise_on,
                    None, pass2, gate)
                outs.append(out)
                seed += stride
        return state, PfBatchOut(x_tbl, *(torch.stack(f) for f in
                                          list(zip(*outs))[1:]))
