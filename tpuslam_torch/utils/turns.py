"""Time K1, the segmented K3b, K5a, the merge's compressed pass 2 (K3c,
K3d) and the PF kernels that share K1's device math of several checkouts
of the port on one card, in turns.

From the repository root, on a CUDA host::

    python -m tpuslam_torch.utils.turns old=path/to/parent new=.

Each ``label=directory`` names a checkout (a directory holding
``pyproject.toml`` and ``tpuslam_torch/``, such as an unpacked ``git
archive`` of another commit).  Each checkout is measured in a process of
its own, which imports that checkout's package and builds its kernels
into that checkout's ``build/``.  The processes run in the order given
and then in the reverse order (old, new, new, old), so a drift of the
card's clocks falls on every side.  Each prints one JSON line with:

* K1's device time a call, noise on (seed 1), at the flagship
  (8,388,608 x 1600; CUDA events, median of 3 after one warm-up) and
  BASELINE (8192 x 400, without and with NEES; 20 calls queued behind a
  sleep kernel) shapes;
* K1's largest kernel-minus-plain difference with noise off (1024 x 50)
  and with injected normals (4096 x 64), ``chip_smoke.py``'s phase 3 and
  4 shapes, and a digest of the kernel's outputs there; a digest of its
  outputs in each mode (noise off, Philox, injected normals), with and
  without NEES, at 8192 x 400 (Philox seed 1) and 8192 x 401 (a seed
  with both key words);
* the wide resample's prerequisites at 1024 x 10,000 with 0, 240 and
  1024 filters firing: K5a with the torch work it needs before it (the
  slot compaction and, before K5a took them in, the quantized prefixes
  of every filter), 20 calls behind a sleep kernel;
  K5a's launch alone, and each operation's device time at 240 firing
  (torch.profiler);
* the segmented K3b's device time a launch at the same three firing
  counts, and a digest of its valid rows;
* K2b at 2,097,152, 1,000,000 and 100,000 particles (Philox noise): the
  device time of ``_step_rows`` (the kernel with, where the checkout has
  one, its torch combine of partial rows) and of the public
  ``pf_fused_predict_weight_stats`` (which also transposes the
  particles), and a digest of the particles and log weights; the same
  digest at 100,000 with noise off and with injected normals, each with
  the restart flag at 0 and at 1.  A checkout whose K2b reads its gate
  from the device takes the flags from there (and, for one more digest,
  the resampled rows in place of the carried ones); the digests equal
  the host-flag form's where the bits agree;
* the single filter's firing step at 2,097,152 (log weights of spread
  4): its pass 1 (the checkout's K3a with the torch work it needs
  before it: the weights, their quantized integers, block prefix and
  ``1 / q_tot`` where the checkout has them) and the whole firing branch
  (pass 1 and K3b), device time a call (20 calls behind a sleep kernel)
  and torch ops a call; K3b alone on the first turn's boundaries; a
  digest of the boundaries and of the rows; where the checkout gates on
  the device, both with the gate off too.  Each checkout's boundaries
  are saved, and the run ends by counting the lanes where they differ
  from the first checkout's;
* K3c and K3d, each single and segmented, firing and idle: the single
  forms on the single filter's state at 2,097,152 after the merge
  rollout's 400 steps (``chip_smoke.py`` phase 27's: boundaries at
  offset 0.5; the gate off for idle), the segmented forms on the
  segmented K3b's inputs at 0, 240 and 1024 firing and on phase 27's
  wide state (``main``: the compressed wide rollout's particles after
  400 steps, K5a's slots on them); each a device time a
  launch and a digest of the stack (values, intervals, counts; valid
  slots) and of the expanded rows.  A checkout whose K3d stages by the
  stack's counts takes them (``cnt=``);
* the device time a launch and a digest of the outputs of K4 at
  8192 x 1000 and K5b at 1024 x 10,000 (Philox noise, a mixed gate),
  which share ``csrc/fastmath.cuh`` with K1; digests of both with noise
  off and with injected normals, and on rare inputs (an observation
  coordinate at 0, particles at 1e30, 1e35, inf and NaN) with, where the
  checkout counts them, the passes whose quotients needed the IEEE
  divide (``_build.div_fallbacks``);
* the single-filter (2,097,152 and 100,000) and wide (1024 x 10,000)
  rollouts' torch ops, device busy time, host wall time and the host's
  wait for the device (``profile_window``'s ``sync_ms``) a step, from a
  profiled 50-step rollout after a warm-up one, at 2,097,152 and
  1024 x 10,000 also on the compressed merge path
  (``merge_caps_kw=(("pass2", "compressed"),)``, ``pass2="compressed"``);
  and the particle-steps a second at 400 steps (CUDA events, median of 3
  after one warm-up) of the single filter at 2,097,152, 1,000,000 and
  100,000 and, on both merge paths, at 2,097,152 and of the wide filter
  at 1024 x 10,000, in the same turns.

K3b, K3c, K3d and K5b read boundaries: every turn takes those of the
first turn (saved under this tree's ``build/turns/``), so their digests
compare the kernels on equal inputs. Each checkout's own K5a boundaries
are saved there too, and the run ends by counting the lanes where each
checkout's differ from the first checkout's. Equal digests mean equal
outputs, bit for bit, across checkouts. Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

FLAGSHIP = (8_388_608, 1600)
BASELINE = (8192, 400)
K1_ODD = (8192, 401)
K1_TWO_WORD_SEED = (0x1234ABCD << 32) | 0x9E37
K3B_SHAPE = (1024, 10_000)
K3B_FIRING = (0, 240, 1024)
K2_SIZES = (2_097_152, 1_000_000, 100_000)
K3_SIZE = K2_SIZES[0]
K4_SHAPE = (8192, 1000)
LOOP_STEPS = 50
RATE_STEPS = 400
MERGE_KW = (("pass2", "compressed"),)
SHARE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "turns"


def _own_profiling():
    """This tree's ``utils/profiling.py``, loaded by its path: a checkout
    under measurement may predate :func:`~tpuslam_torch.utils.device_ms`,
    and every checkout is timed by the same clock."""
    spec = importlib.util.spec_from_file_location(
        "_turns_profiling", pathlib.Path(__file__).with_name("profiling.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digest(*outputs) -> str:
    """A digest of the tensors in ``outputs`` (nested tuples too)."""
    h = hashlib.sha256()
    for t in outputs:
        if isinstance(t, tuple):
            h.update(_digest(*t).encode())
        elif t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ekf_gap(kernel, plain) -> float:
    """Largest |kernel - plain| of a rollout's poses (yaws modulo 2 pi),
    covariance and accumulators."""
    import torch

    worst = 0.0
    for name in ("x_true", "x_dr", "x_hat"):
        a, b = getattr(kernel[0], name), getattr(plain[0], name)
        yaw = torch.remainder(a[:, 2] - b[:, 2] + math.pi, 2 * math.pi)
        worst = max(worst, float((a[:, :2] - b[:, :2]).abs().max()),
                    float((yaw - math.pi).abs().max()))
    worst = max(worst, float((kernel[0].cov - plain[0].cov).abs().max()))
    for a, b in zip(kernel[1:], plain[1:]):
        worst = max(worst, float((a - b).abs().max()))
    return worst


def seg_inputs(dev, b: int, n: int, n_fire: int, seed: int = 16,
               one_survivor: bool = False):
    """K5a's inputs at ``b`` filters of ``n`` particles, with the particles
    they resample: ``(particles, log_w, lse, fire, offs)``.  A spread
    cloud, log weights whose spread grows with the filter, ``n_fire``
    filters spread over the batch firing.  With ``one_survivor`` one
    particle a filter holds all the weight and takes every slot."""
    import torch

    f32 = dict(dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    particles = torch.randn((3, b, n), generator=g, **f32)
    sigma = torch.linspace(0.3, 2.0, b, **f32)[:, None]
    log_w = (sigma * torch.randn((b, n), generator=g, **f32)).contiguous()
    if one_survivor:
        keep = torch.randint(n, (b, 1), generator=g, device=dev)
        log_w = torch.full_like(log_w, -math.inf).scatter_(1, keep, 0.0)
    lse = torch.logsumexp(log_w, dim=1)
    fire = torch.zeros(b, dtype=torch.bool, device=dev)
    fire[torch.linspace(0, b - 1, n_fire, device=dev).round().long()] = True
    offs = torch.rand(b, generator=g, **f32)
    return particles, log_w, lse, fire, offs


def seg_args(dev, b: int, n: int, n_fire: int, seed: int = 16,
             one_survivor: bool = False):
    """The segmented K3b's arguments ``(particles, t_hi, fids, valid)`` on
    :func:`seg_inputs`, the boundaries from K5a."""
    from tpuslam_torch.ops import pf_batch_cuda as pb

    particles, log_w, lse, fire, offs = seg_inputs(dev, b, n, n_fire, seed,
                                                   one_survivor)
    slots = pb.wide_boundary(log_w, lse, fire, offs)
    return particles, slots.t_hi, slots.fids, slots.valid


def _k5a(pb, log_w, lse, fire, offs):
    """``(t_hi, fids, valid, src)`` from a checkout's K5a and the torch
    work before it: ``wide_slots`` (the quantized prefixes of every
    filter in torch) and the prefix form of ``wide_boundary`` where the
    checkout has them, else ``wide_boundary`` of the log weights."""
    if hasattr(pb, "wide_slots"):
        sl = pb.wide_slots(log_w, lse, fire, offs)
        t_hi = pb.wide_boundary(sl.cum, sl.fids, sl.valid, sl.inv_tot,
                                sl.offs)
        return t_hi, sl.fids, sl.valid, sl.src
    sl = pb.wide_boundary(log_w, lse, fire, offs)
    return sl.t_hi, sl.fids, sl.valid, sl.src


def _k5a_launch(pb, k5a_in):
    """A call of the checkout's K5a launch alone on ``k5a_in`` (log
    weights, normalizers, gate, offsets), its torch inputs made first."""
    if hasattr(pb, "wide_slots"):
        sl = pb.wide_slots(*k5a_in)
        return lambda: pb.wide_boundary(sl.cum, sl.fids, sl.valid,
                                        sl.inv_tot, sl.offs)
    return lambda: pb.wide_boundary(*k5a_in)


def _op_times(profile_window, fn) -> str:
    """The device microseconds of each entry one call of ``fn`` shows in
    ``profile_window`` (after a warm-up call)."""
    fn()
    return "; ".join(f"{k[:48]} {1e3 * ms:.1f}"
                     for k, ms in profile_window(fn)["top"])


def _valid_rows(bounds: dict) -> dict:
    """The boundaries' valid rows and the slots, on the host."""
    return {k: (t[v].cpu(), f.cpu(), v.cpu(), s.cpu())
            for k, (t, f, v, s) in bounds.items()}


def _full_rows(saved: dict, dev) -> dict:
    """:func:`_valid_rows`' entries back as ``(B, n)`` boundaries (0 at the
    idle slots) on ``dev``."""
    import torch

    out = {}
    for k, (rows, f, v, s) in saved.items():
        t = torch.zeros((v.shape[0], rows.shape[1]), dtype=rows.dtype)
        t[v] = rows
        out[k] = tuple(x.to(dev) for x in (t, f, v, s))
    return out


def _k3_inputs(dev):
    """The single filter's firing step at :data:`K3_SIZE`: particle rows,
    log weights of spread 4 (the gate fires), their normalizers and a
    comb offset, a 0-d view as the rollout passes it."""
    import torch

    f32 = dict(dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(33)
    n = K3_SIZE
    p_rows = torch.randn((3, n), generator=g, **f32)
    lw = 4.0 * torch.randn(n, generator=g, **f32)
    offs = torch.rand(4, generator=g, **f32)[1]
    return (p_rows, lw, torch.logsumexp(lw, 0), torch.logsumexp(2.0 * lw, 0),
            offs)


def _k3_forms(rs, dev, p_rows, lw, lse, lse2, offs, fire: bool = True):
    """``(pass1, branch)``: a checkout's single-filter firing step at
    :func:`_k3_inputs`: its pass 1 (boundaries) and the whole branch
    (pass 1 and K3b, the resampled rows).  The parent's form is
    ``pf_cuda._step``'s firing branch: the weights, the merge's torch
    prerequisites and K3a, then K3b.  A checkout that gates on the device
    runs its K3a on the log weights, the gate read by the kernels (off
    where ``fire`` is false: no lane of the threshold 0 fires)."""
    import numpy as np
    import torch

    n = lw.shape[0]
    if hasattr(rs, "gated_boundary"):
        ess_min = float(np.float32(n * 0.5)) if fire else 0.0

        def pass1():
            return rs.gated_boundary(lw, lse, lse2, n, offs, ess_min)

        def branch():
            t_hi, gate = pass1()
            return rs.resample_expand(p_rows, t_hi, n, gate=gate)

        return (lambda: pass1()[0]), branch

    def pass1():
        w = torch.exp(lw - lse)
        wq, base, q_tot = rs.quantize_weights(w)
        return rs.resample_boundary(wq, base, 1.0 / q_tot,
                                    rs._offs_on(offs, dev), n)

    def branch():
        return rs.merge_resample_rows(p_rows, torch.exp(lw - lse), n, offs,
                                      device=dev)

    return pass1, branch


def _takes(fn, name: str) -> bool:
    """Whether ``fn`` takes a parameter ``name``."""
    import inspect

    return name in inspect.signature(fn).parameters


def _k3cd_state(rs, dev, share: pathlib.Path):
    """``chip_smoke.py`` phase 27's single-filter stack inputs at
    :data:`K3_SIZE`: the particle rows after the merge rollout's
    :data:`RATE_STEPS` steps (generator seed 0) and the boundaries of
    their weights at offset 0.5.  The first turn saves them; every turn
    reads them."""
    import torch

    path = share / "k3cd_inputs.pt"
    if not path.exists():
        from tpuslam_torch.filters import PfConfig
        from tpuslam_torch.ops import pf_fused_init, pf_fused_rollout

        cfg = PfConfig(num_particles=K3_SIZE, weight_mode="log",
                       resample_method="merge")
        final, _ = pf_fused_rollout(
            cfg, torch.Generator(device=dev).manual_seed(0), RATE_STEPS,
            device=dev)
        fs = pf_fused_init(cfg, final, device=dev)
        t_hi = rs.slot_boundaries(torch.exp(fs.log_w - fs.lse), K3_SIZE,
                                  torch.full((1,), 0.5, device=dev))
        torch.save((fs.particles.cpu(), t_hi.cpu()), path)
    return tuple(t.to(dev) for t in torch.load(path))


def _k3cd_wide_state(dev, share: pathlib.Path):
    """``chip_smoke.py`` phase 27's segmented stack inputs at
    :data:`K3B_SHAPE`: the wide filter's particles after its compressed
    rollout's :data:`RATE_STEPS` steps (generator seed 0, the gate at
    1% of n) and K5a's slots on them (offsets from seed 27):
    ``(particles, t_hi, fids, valid)``.  The first turn saves them; every
    turn reads them."""
    import torch

    path = share / "k3cd_wide_inputs.pt"
    if not path.exists():
        from tpuslam_torch.filters import PfConfig
        from tpuslam_torch.ops import pf_batch_cuda as pb
        from tpuslam_torch.ops import pf_batch_wide_rollout

        b, n = K3B_SHAPE
        cfg = PfConfig(num_particles=n, weight_mode="log",
                       ess_threshold_frac=0.01)
        final, _ = pf_batch_wide_rollout(
            cfg, torch.Generator(device=dev).manual_seed(0), b, RATE_STEPS,
            device=dev, pass2="compressed")
        _, _, fire = pb._gate(cfg, final.lse, final.lse2)
        offs = torch.rand(b, generator=torch.Generator(
            device=dev).manual_seed(27), dtype=torch.float32, device=dev)
        slots = pb.wide_boundary(final.log_w, final.lse, fire, offs)
        torch.save(tuple(t.cpu() for t in (final.particles, slots.t_hi,
                                           slots.fids, slots.valid)), path)
    return tuple(t.to(dev) for t in torch.load(path))


def _compressed(rs, device_ms, dev, share, seg, bounds) -> dict:
    """K3c and K3d of a checkout, single and segmented, firing and idle:
    device time a launch and digests (the module docstring)."""
    import torch

    out = {}
    p_rows, t_hi = _k3cd_state(rs, dev, share)
    n = K3_SIZE
    off = torch.zeros(2, dtype=torch.bool, device=dev)
    stack = rs.compact_particles(p_rows, t_hi)
    kw = {"cnt": stack[2]} if _takes(rs.expand_compressed, "cnt") else {}
    out["k3cd_survivors"] = int(stack[2].sum())
    out["k3c_ms"] = device_ms(lambda: rs.compact_particles(p_rows, t_hi), 50)
    out["k3c_idle_ms"] = device_ms(
        lambda: rs.compact_particles(p_rows, t_hi, gate=off), 50)
    out["k3c_digest"] = _digest(stack)
    out["k3d_ms"] = device_ms(
        lambda: rs.expand_compressed(*stack[:2], n, **kw), 50)
    out["k3d_idle_ms"] = device_ms(
        lambda: rs.expand_compressed(*stack[:2], n, gate=off, **kw), 50)
    out["k3d_digest"] = _digest(rs.expand_compressed(*stack[:2], n, **kw))
    seg_kw = _takes(rs.expand_compressed_seg, "cnt")
    cases = {n_fire: (seg[n_fire], *bounds[f"k3b_{n_fire}"][:3])
             for n_fire in K3B_FIRING}
    cases["main"] = _k3cd_wide_state(dev, share)
    for n_fire, args in cases.items():
        valid = args[3]
        vals, iv, cnt = rs.compact_particles_seg(*args)
        kw = {"cnt": cnt} if seg_kw else {}
        out[f"k3cd_seg_{n_fire}_survivors"] = int(cnt.sum())
        out[f"k3c_seg_{n_fire}_ms"] = device_ms(
            lambda: rs.compact_particles_seg(*args), 20)
        out[f"k3c_seg_{n_fire}_digest"] = _digest(vals[:, valid],
                                                  iv[:, valid], cnt)
        out[f"k3d_seg_{n_fire}_ms"] = device_ms(
            lambda: rs.expand_compressed_seg(vals, iv, valid, **kw), 20)
        out[f"k3d_seg_{n_fire}_digest"] = _digest(
            rs.expand_compressed_seg(vals, iv, valid, **kw)[:, valid])
    return out


def _ops_a_call(profile_window, fn) -> float:
    """The torch ops one call of ``fn`` makes (after a warm-up call)."""
    fn()
    return profile_window(fn, 1)["ops_per_step"]


def _pf_args(dev):
    """K2b's arguments at each of :data:`K2_SIZES`, K4's, and K5b's before
    its boundaries: spread clouds around x0, log weights whose spread
    grows with the filter (a mixed ESS gate), one noisy observation of the
    five landmarks a filter."""
    import torch

    from tpuslam_torch.core.se2 import world_to_robot
    from tpuslam_torch.filters import PfConfig
    from tpuslam_torch.ops import pf_batch_cuda as pb

    f32 = dict(dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    x0 = torch.tensor(PfConfig().x0, **f32)
    lm = torch.tensor(PfConfig().landmarks, **f32)
    z_true = world_to_robot(x0, lm)
    spread = torch.tensor([0.5, 0.5, 0.2], **f32)

    k2 = {}
    for n in K2_SIZES:
        p_rows = (x0[:, None] + spread[:, None]
                  * torch.randn((3, n), generator=g, **f32)).contiguous()
        lw = 2.0 * torch.randn(n, generator=g, **f32)
        z = (z_true + 0.3 * torch.randn(z_true.shape, generator=g, **f32))
        k2[n] = (PfConfig(num_particles=n, weight_mode="log",
                          resample_method="merge"), 12345, 0.0, p_rows, lw,
                 z.contiguous())

    out = {}
    for name, (b, n) in (("k4", K4_SHAPE), ("k5b", K3B_SHAPE)):
        cfg = PfConfig(num_particles=n, weight_mode="log",
                       ess_threshold_frac=0.3)
        parts = (x0[:, None, None] + spread[:, None, None]
                 * torch.randn((3, b, n), generator=g, **f32)).contiguous()
        sigma = torch.linspace(0.3, 2.0, b, **f32)[:, None]
        log_w = (sigma * torch.randn((b, n), generator=g, **f32)
                 ).contiguous()
        st = pb.pf_batch_refresh_stats(cfg, pb.PfBatchState(
            x0, parts, log_w, None, None))
        zb = (z_true + 0.3 * torch.randn((b,) + z_true.shape, generator=g,
                                         **f32)).contiguous()
        if name == "k4":
            out[name] = (cfg, 1, parts, log_w, st.lse, st.lse2, zb)
            continue
        bad, _, fire = pb._gate(cfg, st.lse, st.lse2)
        out[name] = (cfg, parts, log_w, st.lse, zb, bad, fire,
                     torch.rand(b, generator=g, **f32))
    return k2, out["k4"], out["k5b"]


def _k5b_rows(pb):
    """K5b's wrapper, its outputs cut to the five that every checkout
    returns (particles, log weights, lse, lse2, MAP), so that its digests
    compare with those of a checkout whose K5b does not also write the
    next step's gate."""
    return lambda *args, **kw: pb.wide_stats_rows(*args, **kw)[:5]


def _pf_rare(pb, build, dev, k4, k5b_args) -> dict:
    """Digests of K4 and K5b with noise off and with injected normals, and
    on rare inputs: an observation coordinate at 0 (filter 0), particles
    at 1e30 and at 1e35 (filters 1 and 2: quotients beyond the float32
    squares, the second beyond 2**100), at inf and at NaN (filters 3 and
    4).  Where the checkout counts the passes whose landmark quotients
    needed the IEEE divide, the count of one rare launch of each."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for name, fn, args, at in (("k4", pb.pf_batch_step_rows, k4, 2),
                               ("k5b", _k5b_rows(pb), k5b_args, 2)):
        nrm = torch.randn(args[at].shape, generator=gen, device=dev)
        for mode, kw in (("off", dict(noise_on=False)),
                         ("normals", dict(normals=nrm))):
            out[f"{name}_{mode}_digest"] = _digest(tuple(fn(*args, **kw)))
        parts = args[at].clone()
        z_at = 6 if name == "k4" else 4
        z = args[z_at].clone()
        z[0, 0, 0] = 0.0
        for f, value in enumerate((1e30, 1e35, float("inf"),
                                   float("nan")), start=1):
            parts[f % 2, f, 8 * f:8 * f + 8] = value
        rare = list(args)
        rare[at], rare[z_at] = parts, z
        form = "pf_batch_step" if name == "k4" else "wide_stats"
        count = getattr(build, "div_fallbacks", None)
        before = count(dev)[form] if count else 0
        out[f"{name}_rare_digest"] = _digest(tuple(fn(*rare)))
        if count:
            out[f"{name}_rare_div_fallbacks"] = (
                count(dev)[form] - before) % 2**32
    return out


def _measure(tree: pathlib.Path, share: pathlib.Path, label: str) -> dict:
    """The measurements of the module docstring, for the package of
    ``tree``; boundaries are shared through ``share``."""
    sys.path.insert(0, str(tree))
    import torch

    import tpuslam_torch
    from tpuslam_torch.filters import EkfConfig
    from tpuslam_torch.ops import _build, ekf_cuda, pf_cuda
    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import timed

    profiling = _own_profiling()
    device_ms, profile_window = profiling.device_ms, profiling.profile_window

    pkg = pathlib.Path(tpuslam_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    dev = torch.device("cuda", 0)
    _build.load_library()
    cfg = EkfConfig()
    out = {"build_s": _build.build_seconds}

    res = {}

    def flagship():
        res["f"] = ekf_cuda.ekf_fused_rollout(cfg, 1, *FLAGSHIP, device=dev)

    out["k1_flagship_ms"] = 1e3 * timed(flagship, reps=3, warmup=1,
                                        device=dev)
    b, n = FLAGSHIP
    out["k1_flagship_rmse"] = float(torch.sqrt(res.pop("f")[1] / n).mean())
    out["k1_baseline_ms"] = device_ms(
        lambda: ekf_cuda.ekf_fused_rollout(cfg, 1, *BASELINE, device=dev),
        20)
    out["k1_baseline_nees_ms"] = device_ms(
        lambda: ekf_cuda.ekf_fused_rollout(cfg, 1, *BASELINE,
                                           with_nees=True, device=dev), 20)

    kern = ekf_cuda.ekf_fused_rollout(cfg, 0, 1024, 50, noise_on=False,
                                      device=dev)
    plain = ekf_cuda.ekf_fused_rollout_plain(cfg, 0, 1024, 50,
                                             noise_on=False, device=dev)
    out["k1_off_err"] = _ekf_gap(kern, plain)
    out["k1_off_digest"] = _digest(*kern[0], *kern[1:])
    gen = torch.Generator(device=dev).manual_seed(2024)
    normals = torch.randn((64, 5, 4096), generator=gen, device=dev)
    kern = ekf_cuda.ekf_fused_rollout(cfg, 0, 4096, 64, normals=normals,
                                      with_nees=True, device=dev)
    plain = ekf_cuda.ekf_fused_rollout_plain(cfg, 0, 4096, 64,
                                             normals=normals,
                                             with_nees=True, device=dev)
    out["k1_normals_err"] = _ekf_gap(kern, plain)
    out["k1_normals_digest"] = _digest(*kern[0], *kern[1:])
    # Every mode with and without NEES at BASELINE (Philox seed 1) and at
    # an odd step count (a seed with both key words in play).
    for (b, n), seed in ((BASELINE, 1), (K1_ODD, K1_TWO_WORD_SEED)):
        normals = torch.randn((n, 5, b), generator=gen, device=dev)
        for mode, kw in (("off", dict(noise_on=False)), ("philox", {}),
                         ("normals", dict(normals=normals))):
            for nees in (False, True):
                kern = ekf_cuda.ekf_fused_rollout(cfg, seed, b, n,
                                                  with_nees=nees, device=dev,
                                                  **kw)
                out[f"k1_{mode}_{b}x{n}{'_nees' * nees}_digest"] = _digest(
                    *kern[0], *kern[1:])

    # K5a: each checkout's own boundaries, timed with the torch work
    # before them; K3b and K5b then read the first turn's.
    k2, k4, k5b = _pf_args(dev)
    seg, bounds = {}, {}
    for n_fire in K3B_FIRING:
        particles, *k5a_in = seg_inputs(dev, *K3B_SHAPE, n_fire)
        out[f"k5a_{n_fire}_ms"] = device_ms(lambda: _k5a(pb, *k5a_in), 20)
        out[f"k5a_launch_{n_fire}_ms"] = device_ms(_k5a_launch(pb, k5a_in),
                                                   20)
        bounds[f"k3b_{n_fire}"] = _k5a(pb, *k5a_in)
        seg[n_fire] = particles
        if n_fire == K3B_FIRING[1]:
            out[f"k5a_{n_fire}_ops_us"] = _op_times(
                profile_window, lambda: _k5a(pb, *k5a_in))
    cfg_w, parts_w, lw_w, lse_w, z_w, bad_w, fire_w, offs_w = k5b
    bounds["k5b"] = _k5a(pb, lw_w, lse_w, fire_w, offs_w)
    share.mkdir(parents=True, exist_ok=True)
    torch.save(_valid_rows(bounds), share / f"{label}.pt")
    common = share / "inputs.pt"
    if not common.exists():
        torch.save(_valid_rows(bounds), common)
    bounds = _full_rows(torch.load(common), dev)

    for n_fire in K3B_FIRING:
        t_hi, fids, valid, _ = bounds[f"k3b_{n_fire}"]
        args = (seg[n_fire], t_hi, fids, valid)
        out[f"k3b_{n_fire}_ms"] = device_ms(
            lambda: rs.resample_expand_seg(*args), 20)
        rows = rs.resample_expand_seg(*args)
        out[f"k3b_{n_fire}_digest"] = _digest(rows[:, valid])

    gated = hasattr(rs, "gated_boundary")

    def k2b(args, noise, flag: float, take: bool = False):
        """K2b's ``(p', lw')``: the host flag, or the device gate
        ``[take, flag]`` with the carried rows (or, with ``take``, the
        resampled ones: the carried rows then hold other values)."""
        if not gated:
            return pf_cuda._step_rows(*args[:2], flag, *args[3:], *noise,
                                      True, False)[:2]
        gate = torch.tensor([take, flag > 0], device=dev)
        carried = torch.zeros_like(args[3]) if take else args[3]
        return pf_cuda._step_rows(*args[:3], carried, *args[4:], *noise,
                                  True, False, gate=gate,
                                  p_alt=args[3])[:2]

    for n, args in k2.items():
        p_nt = args[3].T.contiguous()
        out[f"k2b_{n}_ms"] = device_ms(
            lambda: pf_cuda._step_rows(*args, True, None, True, False), 20)
        out[f"k2b_api_{n}_ms"] = device_ms(
            lambda: pf_cuda.pf_fused_predict_weight_stats(
                *args[:3], p_nt, *args[4:]), 20)
        out[f"k2b_{n}_digest"] = _digest(tuple(k2b(args, (True, None),
                                                   0.0)))
    # Modes 0 (noise off), 1 (Philox) and 2 (injected normals) at the
    # smallest size, the restart flag at 0 and 1, and the resampled rows.
    args = k2[K2_SIZES[-1]]
    normals = torch.randn((3, K2_SIZES[-1]), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(7))
    for mode, noise in (("off", (False, None)), ("philox", (True, None)),
                        ("normals", (True, normals))):
        for flag in (0.0, 1.0):
            out[f"k2b_{mode}_flag{int(flag)}_digest"] = _digest(tuple(
                k2b(args, noise, flag)))
        if gated:  # the parent has no resampled rows: as flag 1
            out[f"k2b_{mode}_take_digest"] = _digest(tuple(
                k2b(args, noise, 1.0, take=True)))

    # The single filter's firing step: each checkout's boundaries, K3b on
    # the first turn's.
    k3_in = _k3_inputs(dev)
    pass1, branch = _k3_forms(rs, dev, *k3_in)
    out["k3a_ms"] = device_ms(pass1, 20)
    out["k3a_ops"] = _ops_a_call(profile_window, pass1)
    out["k3_branch_ms"] = device_ms(branch, 20)
    out["k3_branch_ops"] = _ops_a_call(profile_window, branch)
    t_own = pass1()
    out["k3a_digest"] = _digest(t_own)
    out["k3a_ops_us"] = _op_times(profile_window, pass1)
    if gated:
        idle1, idle_branch = _k3_forms(rs, dev, *k3_in, fire=False)
        out["k3a_idle_ms"] = device_ms(idle1, 20)
        out["k3_branch_idle_ms"] = device_ms(idle_branch, 20)
    torch.save(t_own.cpu(), share / f"{label}_k3a.pt")
    common_t = share / "k3a_inputs.pt"
    if not common_t.exists():
        torch.save(t_own.cpu(), common_t)
    t_first = torch.load(common_t).to(dev)
    p_k3 = k3_in[0]
    out["k3b_ms"] = device_ms(lambda: rs.resample_expand(p_k3, t_first,
                                                          K3_SIZE), 50)
    out["k3b_digest"] = _digest(rs.resample_expand(p_k3, t_first, K3_SIZE))
    out.update(_compressed(rs, device_ms, dev, share, seg, bounds))

    t_hi, fids, valid, src = bounds["k5b"]
    expanded = rs.resample_expand_seg(parts_w, t_hi, fids, valid)
    k5b_args = (cfg_w, 1, parts_w, lw_w, z_w, bad_w, fire_w, src, expanded)
    for name, fn in (("k4", lambda: pb.pf_batch_step_rows(*k4)),
                     ("k5b", lambda: _k5b_rows(pb)(*k5b_args))):
        out[f"{name}_ms"] = device_ms(fn, 20)
        out[f"{name}_digest"] = _digest(tuple(fn()))
    out.update(_pf_rare(pb, _build, dev, k4, k5b_args))

    # The loops: a profiled rollout of each after a warm-up one.
    from tpuslam_torch.filters import PfConfig
    from tpuslam_torch.ops import pf_batch_wide_rollout, pf_fused_rollout

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def single(n):
        return PfConfig(num_particles=n, weight_mode="log",
                        resample_method="merge")

    wide = PfConfig(num_particles=K3B_SHAPE[1], weight_mode="log",
                    ess_threshold_frac=0.01)
    def single_run(n, steps, **kw):
        return pf_fused_rollout(single(n), gen(), steps, device=dev, **kw)

    def wide_run(steps, **kw):
        return pf_batch_wide_rollout(wide, gen(), K3B_SHAPE[0], steps,
                                     device=dev, **kw)

    for name, fn in (
            ("single", lambda: single_run(K2_SIZES[0], LOOP_STEPS)),
            ("single_100k", lambda: single_run(K2_SIZES[-1], LOOP_STEPS)),
            ("wide", lambda: wide_run(LOOP_STEPS)),
            ("single_compressed", lambda: single_run(
                K2_SIZES[0], LOOP_STEPS, merge_caps_kw=MERGE_KW)),
            ("wide_compressed", lambda: wide_run(LOOP_STEPS,
                                                 pass2="compressed"))):
        fn()
        got = profile_window(fn, LOOP_STEPS)
        out[f"{name}_ops_a_step"] = got["ops_per_step"]
        out[f"{name}_busy_ms_a_step"] = got["busy_ms"] / LOOP_STEPS
        out[f"{name}_wall_ms_a_step"] = got["wall_ms"] / LOOP_STEPS
        out[f"{name}_sync_ms_a_step"] = got["sync_ms"] / LOOP_STEPS
    # The rates at bench.py's sizes, unprofiled.
    b, n_w = K3B_SHAPE
    rates = [(f"single_{n}", n, lambda n=n: single_run(n, RATE_STEPS))
             for n in K2_SIZES]
    rates += [
        (f"single_compressed_{K2_SIZES[0]}", K2_SIZES[0],
         lambda: single_run(K2_SIZES[0], RATE_STEPS,
                            merge_caps_kw=MERGE_KW)),
        ("wide", b * n_w, lambda: wide_run(RATE_STEPS)),
        ("wide_compressed", b * n_w,
         lambda: wide_run(RATE_STEPS, pass2="compressed"))]
    for name, work, fn in rates:
        seconds = timed(fn, reps=3, warmup=1, device=dev)
        out[f"{name}_rate"] = work * RATE_STEPS / seconds
    torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(_measure(pathlib.Path(argv[1]).resolve(),
                                  pathlib.Path(argv[2]), argv[3])))
        return 0
    trees = []
    for arg in argv:
        label, _, path = arg.partition("=")
        root = pathlib.Path(path).resolve()
        if not label or not (root / "tpuslam_torch").is_dir():
            raise SystemExit(f"usage: turns label=checkout ...; bad {arg!r}")
        trees.append((label, root))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shutil.rmtree(SHARE_DIR, ignore_errors=True)
    runs = {label: [] for label, _ in trees}
    for label, root in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(root),
             str(SHARE_DIR), label],
            cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({root}) failed:\n{proc.stderr}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(result)
        print(f"turn {label}: {json.dumps(result)}", flush=True)
    keys = dict.fromkeys(k for rs in runs.values() for r in rs for k in r)
    for key in keys:
        print(f"{key}: " + "; ".join(
            f"{label} " + ", ".join(
                f"{r[key]:.4f}" if isinstance(r.get(key), float)
                else str(r.get(key, "-")) for r in runs[label])
            for label, _ in trees), flush=True)
    _count_boundaries(trees)
    print(f"on {smi}", flush=True)
    return 0


def _count_boundaries(trees) -> None:
    """Print, for each checkout after the first, the K5a boundaries (valid
    lanes) and the single filter's K3a boundaries that differ from the
    first checkout's, and where the slots differ."""
    import torch

    first = trees[0][0]
    ref_t = torch.load(SHARE_DIR / f"{first}_k3a.pt")
    for label, _ in trees[1:]:
        got_t = torch.load(SHARE_DIR / f"{label}_k3a.pt")
        print(f"k3a boundaries of {label} differing from {first}'s: "
              f"{int((ref_t != got_t).sum())} of {ref_t.numel():,}",
              flush=True)
    ref = torch.load(SHARE_DIR / f"{first}.pt")
    for label, _ in trees[1:]:
        got = torch.load(SHARE_DIR / f"{label}.pt")
        parts = []
        for key, (rows, *slots) in ref.items():
            o_rows, *o_slots = got[key]
            if not all(torch.equal(a, b) for a, b in zip(slots, o_slots)):
                parts.append(f"{key} slots differ")
                continue
            parts.append(f"{key} {int((rows != o_rows).sum())} of "
                         f"{rows.numel():,}")
        print(f"k5a boundaries of {label} differing from {first}'s: "
              + "; ".join(parts), flush=True)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
