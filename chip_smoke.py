#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one CUDA card: the batched
EKF, the single-filter, batched and wide particle filters, the merge
resample's compressed path, and dense and large-scale graph SLAM.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``tpuslam_torch/csrc`` and prints each
kernel's compiler and occupancy report, holds each kernel
against its plain torch version on the card, checks the noisy filters
against their statistical bands, drives each path through the calls a
user makes (the EKF entry point; the fused PF rollout at 2,097,152
particles x 400 steps; the batched PF at 8192 filters x 1000 particles
and the wide PF at 1024 x 10,000, 400 steps each; the fused PF rollout
with ``merge_caps_kw=(("pass2", "compressed"),)`` and the wide PF with
``pass2="compressed"`` at the same sizes) with the
kernels' launch counts set to 0 just before and read just after (and, on
every particle-filter path, the host synchronisations counted, which must
be 0: the single filter's merge gates on the device), and times the
kernels and the plain versions at the main paths' shapes, holding the
timed outputs to the plain versions' or to their bands.  Then it runs
dense graph SLAM, which has no hand-written kernel: the reference course
(18 frames, 9 landmarks) in float32 against float64 and against the CPU,
1024 seeds of it batched with each guard (timed, profiled, its statistics
held to the reference's bands, and repeated bit for bit: at 256 seeds
with the full guard), and one full-history solve of 400 and of 1000
steps.  Then large-scale graph SLAM (phases 32-35), whose Thomas factor
is K6 on the card: a 200-pose scene solved in float32 on the card
against float64 on the CPU on each solver path (the tridiagonal Thomas
solver with factor reuse, one-shot, with ``refactor_every`` 1 and 3, and
CG), the end-to-end test's scene held to its RMSE bound, the staged
Thomas solves bit for bit against the one-shot ones; ``bench.py``'s
``bench_graph_large`` at 10k poses / 1k landmarks, 100k / 1k and 1M /
100 (the scene and the edge build timed apart, the device edge build
against the host's, the solve timed with its host syncs counted, repeats
bit for bit, float64 at 10k, the Thomas factor and one GN iteration timed
apart with the host clock a chain step, a profile of each at 10k, the
solve and the factor timed again with the plain chain in K6's place); and
one CG solve at 10k with its host syncs.  Then the other banded solvers
(phases 36-38): on the 200-pose scene, the GN with cyclic reduction, with
the banded Cholesky and with the partitioned Thomas factor (2 and 5
chunks) in float32 on the card against float64 on the CPU, CR against
Thomas on random blocks and the partitioned solves against the
sequential ones in float64; at each of the three sizes, on its H, the
CR one-shot solve against the Thomas one-shot solve (timed, its repeats
bit for bit and its gap to float64 at 10k, one solve profiled with its
launches a level, and a level's SPD solve in its two forms), the
partitioned factor and resolve at 8, 32 and 128 chunks, and the GN with
CR and with the best chunk count, held to the Thomas path's poses; and
one banded Cholesky solve at 10k.  Last (phase 39), K6 on the
graph_large cell's chain (32 seeded 10k-pose scenes): one launch a
factor, two launches bit-equal, K6 and the plain chain held to float64,
K6's time beside its bound, the plain chain's eager and as a CUDA graph,
and K6 on one scene.  Each phase
prints one line; a failing phase raises, so
the script exits non-zero and prints no result.  The second-to-last
line is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  It needs a CUDA device and imports no
JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time

# Bench shapes of the main path: the flagship (rollouts x steps) and the
# latency-bound BASELINE config 3, plus the stacked-sweeps variant.
FLAGSHIP = (8_388_608, 1600)
BASELINE = (8192, 400)
SWEEPS = (64, 8192, 400)
# An odd step count, held to the plain version with Philox noise.
ODD_SHAPE = (4096, 63)

# Bands of the noisy filter at 8192 x 400: per-rollout RMSE and NEES of the
# posterior position, as the JAX package's on-chip gate holds them.
RMSE_BAND = (0.25, 0.50)
NEES_BAND = (0.7, 2.5)

# The PF path at bench.py's sizes (bench.py:569, :559, :553: particles x
# steps through bench_pf_pallas, bench.py:109), and the band of the fused
# PF's position RMSE at 100,000 x 100 (bench.py:468-474).
PF_SIZES = (2_097_152, 1_000_000, 100_000)
PF_STEPS = 400
PF_BAND = (0.02, 0.40)
PF_BAND_SHAPE = (100_000, 100)
# The step-kernel parity phase: (particles, noise on, injected normals).
# The flagship count and 100,000 (196 blocks of 512 particles), injected
# normals at 65,536, and a ragged count (not a multiple of 4: scalar rows,
# a partial last thread) in every mode.
PF_STEP_CHECK = ((2_097_152, False, False), (2_097_152, True, False),
                 (100_000, True, False), (65_536, True, True),
                 (99_999, False, False), (99_999, True, False),
                 (99_999, True, True))

# The batched and wide paths at bench.py's sizes (filters x particles, 400
# steps: bench_pf_batch, bench.py:128-144, :576-587; bench_pf_batch_wide,
# :147-164, :594-608).  The first of each is the main path, the JAX
# package's full width.  Their bands: position RMSE over every filter and
# step at 256 x 1000 x 100 and 32 x 10,000 x 100 (bench.py:476-488).
BATCH_SIZES = ((8192, 1000), (1024, 1000))
WIDE_SIZES = ((1024, 10_000), (128, 10_000))
BATCH_MAIN, WIDE_MAIN = BATCH_SIZES[0], WIDE_SIZES[0]
# K4 and K5b are also held to their twins at ragged shapes: K4 with rows
# that are not 16-byte aligned and a partial last thread, once in one pass
# of the block and once in five; K5b with scalar rows and a ragged last
# pass of its block, and at 128 filters, one block a SM.
BATCH_RAGGED = ((8192, 997), (256, 4099))
WIDE_RAGGED = ((64, 10_001), (128, 10_000))
# The segmented K3b's firing counts at WIDE_MAIN (timed: its fixed cost
# against its cost a firing filter), and its edge shapes with every filter
# firing: one survivor a filter (one particle takes every slot), ragged
# rows, and rows longer than a block's shared memory holds.
EXPAND_FIRING = (0, 240, 1024)
EXPAND_EDGES = ((1024, 10_000, True), (64, 10_001, False),
                (64, 10_001, True), (8, 100_000, False), (8, 100_000, True))
# K5a's firing counts at WIDE_MAIN (the same three, timed) and its edge
# shapes (filters, particles, firing, one survivor a filter): ragged rows,
# 16 x 100,000 (PERF.md section 7), every filter firing with one particle
# holding all of a filter's weight.
BOUNDARY_EDGES = ((64, 10_001, 13, False), (16, 100_000, 16, False),
                  (1024, 10_000, 1024, True), (64, 10_001, 64, True))
BATCH_BAND = (0.02, 0.50)
BATCH_BAND_SHAPE = (256, 1000, 100)
WIDE_BAND_SHAPE = (32, 10_000, 100)

# The least time the card could take: bytes over the HBM rate against
# operations over their rate, float32 on the non-tensor-core float32 rate
# (NVIDIA H100 SXM data sheet) and 32-bit integer on 64 results a clock an
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) on 132 SMs at the 1.98 GHz that the data sheet's
# float32 rate implies.  Operations a rollout-step, particle or lane,
# counted from the plain versions' arithmetic (ekf_cuda.py,
# pf_cuda.py::_predict_loglik, resample_cuda.py); exp, log, sqrt and a
# divide count one each.  K1's float32 count is 224 for the filter and 32
# for each of its 2.5 Box-Muller transforms a step; its integer count is
# Philox's, 39 a call, 1.5 calls a step, plus the transforms' two shifts.
# A Philox round is two 32x32->64 products and two three-input XORs, less
# the first round's second product, whose factor (the counter's third
# word, 0 or 1) is a constant.  Each counts as one operation, the fewest
# the card could need: K1's SASS (kernel_report) issues a product as one
# IMAD.WIDE.U32 and a three-input XOR as one LOP3.LUT.  So the int32 term
# stays below the float32 one.
# The PF kernels' Philox is left out of their counts (their bytes bound
# them).  PF_STEP_OPS includes the 5 operations of the reductions (exp,
# shift, square, sums).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
EKF_OPS_PER_STEP = 224 + 2.5 * 32
EKF_INT_OPS_PER_STEP = 1.5 * 39 + 2.5 * 2
PF_STEP_OPS = 240
BOUNDARY_OPS = 6
# K5a's float work a lane of a firing filter beside the boundary law:
# subtract, exp, the row sum's add, the scale's multiply, round, and the
# prefix's add.
K5A_OPS = BOUNDARY_OPS + 6

# The single-filter rollout's keywords for its compressed path, and the
# gate of the one-step wide comparison (phase 24: about a fifth of
# _batch_inputs' filters, whose ESS runs from about 0.9 n down to 0.02 n,
# fall under it).
MERGE_KW = (("pass2", "compressed"),)
WIDE_STEP_FRAC = 0.08

# Dense graph SLAM on the reference course (reference_course_config: 9
# landmarks, graph_based_slam.py:900-927): its 18 frames, the seed count
# the JAX package's users vmap (tests/test_distributional.py:161, the
# bands of scripts/gen_ref_distributions.py), the first 100 of them held
# to the "graph" band and a 64-seed 6-frame run to "graph_fast"; the f32
# result held to f64 at tests/test_graph.py:107-108's bound.  The long
# solves: 400 steps with the full guard, 1000 with the cheap one.
GRAPH_FRAMES = 18
GRAPH_SEEDS = 1024
GRAPH_REPEAT_SEEDS = 256
GRAPH_BAND_SEEDS = 100
GRAPH_FAST_SEEDS = 64
GRAPH_ALONE = 4
GRAPH_ATOL = 2e-2
GRAPH_LONG = ((400, "full"), (1000, "cheap"))
BANDS_FILE = (pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
              / "ref_distributions.json")
# Large-scale graph SLAM (bench.py:191-240, bench_graph_large), its config
# copied: BASELINE config 5, 10k poses / 1k landmarks (bench.py:621), and
# the scale-ups 100k / 1k (:631) and 1M / 100 (:641): window = band =
# super-block 40, course radius radius_frac x poses, odometry noise 0.1, 10
# GN iterations, exact Jacobians, odom_info (100, 100, 100), the tridiag
# solver with factor reuse, stall_ratio 0.5, delta_tol 1e-6 x poses; the
# scan in chunks of 10,000 poses past 10k.  Each row: poses, landmarks,
# scan_chunk, radius_frac.
LARGE_SIZES = ((10_000, 1000, None, 0.3), (100_000, 1000, 10_000, 0.3),
               (1_000_000, 100, 10_000, 0.05))
LARGE_WINDOW = 40
LARGE_ODOM_NOISE = 0.1
LARGE_ODOM_INFO = (100.0, 100.0, 100.0)
LARGE_STALL = 0.5
LARGE_TOL_PER_POSE = 1e-6
LARGE_REPS = 3
# The 10k solve against the port's float64 solve on the card: position
# and yaw.
LARGE_F64_ATOL = (1e-3, 1e-4)
# RMSE against truth over the odometry's: TestLargeSceneEndToEnd's scene
# (phase 32) is held below 0.7, as that test holds it.  At the bench's
# config the ratio is only printed: its stall_ratio stops GN after a few
# iterations, short of convergence, and its landmarks (a few sightings
# each, no loop closure) add little to odometry of 0.1 a step, so the
# JAX package's own ratio there is near 1, on either side of it
# (tests/test_torch_slam_large.py::TestBenchConfig).  What GN must do
# there is lower its objective (frozen Omega): held at every size.
LARGE_RMSE_RATIO = 0.7
LARGE_E2E_DRAWS = BANDS_FILE.parent / "large_scene_key0.npz"
# The Thomas factor's least time a super-block of m = 3 x 40 scalars:
# 4 m^3 float32 operations (W = I U 2 m^3, the lower half of S = D - U^T W
# m^3, the Cholesky, the triangular inverse and the lower half of X^T X
# m^3 / 3 each) and 3 m^2 float32 words written (S^-1, W and the coupling
# block kept for the substitution).  The chain is sequential: reaching
# this bound would take the parallel work a step does not have.  The
# benchmark's roofline (bench_torch/roofline/graph_large.py) counts the
# plain chain's general products instead, 22/3 m^3.
THOMAS_OPS_PER_M3 = 4
# Phase 39: K6 on the graph_large cell's chain, THOMAS_SCENES seeded scenes
# of LARGE_SIZES[0] (N = 250 super-blocks of M = 120), and the cell's
# 32-scene solve.  Its bound counts THOMAS_OPS_PER_M3 and 16 M^2 bytes a
# step and matrix (D and U read, W and S^-1 written).  K6 and the plain
# chain round differently (sums of depth 120 in other orders, other
# Cholesky and inverse algorithms), so each is held to the chain in
# float64: K6's error at most THOMAS_ERR_RATIO x the plain chain's plus
# THOMAS_ERR_FLOOR of the largest entry
# (tests/test_torch_slam_thomas_card.py's bound).
THOMAS_SCENES = 32
THOMAS_ERR_RATIO = 2.0
THOMAS_ERR_FLOOR = 1e-6
# Phase 32: TestLargeSceneEndToEnd's scene (poses, landmarks, radius,
# odometry noise, window), float32 on the card against float64 on the
# CPU.  The tridiag runs stop at delta_tol 1e-2 x poses, above the float32
# solve's noise (a first step of ||dx||^2 ~ 1e4 leaves ~1e-2 of float32
# noise in the second), so both precisions stop at the same iteration.
# Float32 CG needs about 300 iterations on this system (the 1e4 anchor
# makes it stiff): with the default 200 its poses part from float64's by
# up to 2e-2, so the CG run takes 1000 and a fixed LARGE_SMALL_CG_GN
# iterations (delta_tol 0), and the poses are what it holds.
LARGE_SMALL = (200, 40, 60.0, 0.3, 30)
LARGE_SMALL_TOL = 1e-2
LARGE_SMALL_CG = 1000
LARGE_SMALL_CG_GN = 4
LARGE_SMALL_ATOL = 1e-3
# Phases 36-37: the partitioned factor's chunk counts at 200 poses (eight
# and ten super-blocks of 30 after its padding: chunks of four and of two
# super-blocks, the reference's m >= 3 and m == 2 branches) and at the
# bench's sizes (the TPU script's sweep, scripts/tpu_graph1m_phases_r5.py:
# 133); CR against Thomas on random SPD blocks (float32,
# tests/test_large_graph.py's bound); the partitioned solves against the
# sequential in float64, relative to the largest magnitude; the GN's poses
# against the Thomas path's (the JAX tests' cross-solver bound).
LARGE_SMALL_PARTS = (2, 5)
LARGE_PARTS = (8, 32, 128)
LARGE_CR_BLOCK_ATOL = 1e-4
LARGE_PART_RTOL = 1e-10
LARGE_CROSS_ATOL = 2e-2
# CR's least time: about 10.4 m^3 float32 operations a padded super-block
# over the levels (an odd block's Cholesky m^3/3, its two triangular
# solves of 2m + 1 columns 4 m^3, and three products 6 m^3, at level 0 on
# half the blocks and the levels summing to twice that), and 3 m^2 words
# of each block's diagonal, coupling and kept factor written once.
CR_OPS_PER_M3 = 10.4

# tests/test_distributional.py's check: means within K_SIGMA combined
# standard errors, spreads within a factor STD_RATIO.
K_SIGMA = 8.0
STD_RATIO = 1.75


def _require(ok, message) -> None:
    """Raise unless ``ok``: a failed check ends the run."""
    if not ok:
        raise RuntimeError(message)


def _yaw_gap(a, b):
    """|a - b| modulo 2*pi, in [0, pi]."""
    import torch

    return torch.remainder(a - b + math.pi, 2 * math.pi).sub(math.pi).abs()


def _compare(kernel, plain, *, atol_state, rtol_cov, atol_cov):
    """Max abs differences of two rollout results; raises past tolerance.

    Yaw rows are compared modulo 2*pi.  Returns the largest state or
    covariance difference.
    """
    k_state, k_err = kernel[0], kernel[1:]
    p_state, p_err = plain[0], plain[1:]
    worst = 0.0
    for name in ("x_true", "x_dr", "x_hat"):
        a, b = getattr(k_state, name), getattr(p_state, name)
        _require(a.shape == b.shape and bool(a.isfinite().all()),
                 f"{name}: shape or finiteness")
        gap = max(float((a[:, :2] - b[:, :2]).abs().max()),
                  float(_yaw_gap(a[:, 2], b[:, 2]).max()))
        _require(gap <= atol_state,
                 f"{name}: kernel vs plain {gap} > {atol_state}")
        worst = max(worst, gap)
    a, b = k_state.cov, p_state.cov
    gap = (a - b).abs()
    _require(bool((gap <= atol_cov + rtol_cov * b.abs()).all()),
             f"cov: kernel vs plain max {float(gap.max())}")
    worst = max(worst, float(gap.max()))
    for a, b in zip(k_err, p_err):
        gap = (a - b).abs()
        _require(bool((gap <= 1e-6 + 1e-4 * b.abs()).all()),
                 f"accumulator: kernel vs plain max {float(gap.max())}")
    return worst


def _k1_both_forms(cfg, seed, b, n, dev, tol, *, noise_on=True,
                   with_nees=False, normals=None):
    """K1 at ``b`` rollouts, which takes its small-batch form (four lanes
    a rollout), and at the smallest batch that takes the one-thread form,
    each held to the plain version at ``tol`` (:func:`_compare`'s
    keywords).  The small launch's output words must equal the large
    launch's first ``b`` rollouts' (a rollout's Philox stream does not
    depend on the batch; injected ``normals`` are given for the large
    batch and the small launch takes their first ``b`` columns).  Each
    launch must add one to ``_build.launches`` under its form
    (``ekf_rollout_lanes`` for the small-batch form, ``ekf_rollout`` for
    the one-thread form) and nothing else.  Returns the largest gap to
    the plain version and both launches' outputs."""
    import torch

    from tpuslam_torch.ops import _build, ekf_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    large = ekf_cuda.LANES_BELOW_PER_SM * sms
    worst, outs = 0.0, []
    for batch, lanes in ((b, 4), (large, 1)):
        _require(ekf_cuda.k1_lanes(batch, sms) == lanes,
                 f"k1_lanes({batch}, {sms}) is not {lanes}")
        kw = dict(noise_on=noise_on, with_nees=with_nees, device=dev)
        if normals is not None:
            kw["normals"] = normals[:, :, :batch].contiguous()
        counts = _build.launches.copy()
        counts["ekf_rollout_lanes" if lanes > 1 else "ekf_rollout"] += 1
        kern = ekf_cuda.ekf_fused_rollout(cfg, seed, batch, n, **kw)
        _require(_build.launches == counts, f"K1 {batch}x{n}: launches "
                 f"{dict(_build.launches)}, want {dict(counts)}")
        plain = ekf_cuda.ekf_fused_rollout_plain(cfg, seed, batch, n, **kw)
        worst = max(worst, _compare(kern, plain, **tol))
        outs.append(kern)
    small, big = ([t.contiguous().view(torch.int32)
                   for t in (*out[0], *out[1:])] for out in outs)
    for name, s, g in zip(("x_true", "x_dr", "x_hat", "cov", "sq_err",
                           "nees"), small, big):
        _require(torch.equal(s, g[:b]),
                 f"K1 {b}x{n}: small-batch form's {name} differs from the "
                 f"one-thread form's first {b} rollouts")
    return worst, outs


def _k1_floors(clock_mhz: float) -> dict | None:
    """2b. K1's floors at :data:`FLAGSHIP` from its step loop's SASS
    (``kernel_report.floors_ms``): the issue floor and each pipe's.  The
    loop reads the four truth-table words a step, so its ``LDG`` count
    over 4 is the steps it holds.  None where no ``cuobjdump`` is
    found."""
    from tpuslam_torch.utils import kernel_report as kr

    found = kr.counts_of("ekf_rollout_kernel<1, false")
    if found is None or "loop" not in found[1]:
        print("K1 floors: not measured (no SASS or no loop found)",
              flush=True)
        return None
    name, counts = found
    loop = counts["loop"]
    steps = loop.get("LDG/STG", 0) / 4
    _require(steps >= 1 and steps == int(steps),
             f"K1 step loop: {loop.get('LDG/STG', 0)} loads")
    per_step = {g: c / steps for g, c in loop.items()}
    b, n = FLAGSHIP
    floors = kr.floors_ms(per_step, b * n, clock_mhz * 1e6)
    pipes = ", ".join(f"{p} {floors[p]:.3f} ms" for p, _, _ in kr.PIPES)
    print(f"K1 floors at {b:,}x{n} ({name}, step loop {loop['total']} "
          f"instructions for {steps:g} step(s): {per_step['total']:.1f} a "
          f"step, of them fp32 {per_step.get('FFMA/FMUL/FADD', 0):.1f}, "
          f"MUFU {per_step.get('MUFU', 0):.1f}; {clock_mhz:g} MHz max SM "
          f"clock): issue {floors['issue']:.3f} ms; pipes {pipes}",
          flush=True)
    return floors


def _bound(n_bytes: float, n_ops: float, n_int_ops: float = 0.0):
    """``(bound_ms, bound_by)``: the largest of the least times for the
    bytes, the float32 operations and the integer operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_ops / F32_OPS_PER_S, n_int_ops / INT32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _step_gap(kernel, plain, what: str = "pf_step"):
    """Largest |kernel - plain| of a PF step's poses (yaw modulo 2*pi)
    and of its log weights, rows ``(3, ...)`` and ``(...)``; raises past
    atol 1e-4 on poses and 1e-4 + 1e-5 |lw| on log weights (FMA
    contraction against separate roundings, over five landmark terms)."""
    (kp, klw, _), (pp, plw, _) = kernel, plain
    _require(kp.shape == pp.shape and bool(kp.isfinite().all()),
             f"{what} rows: shape or finiteness")
    pose = max(float((kp[:2] - pp[:2]).abs().max()),
               float(_yaw_gap(kp[2], pp[2]).max()))
    _require(pose <= 1e-4, f"{what} poses: kernel vs plain {pose}")
    d = (klw - plw).abs()
    _require(bool((d <= 1e-4 + 1e-5 * plw.abs()).all()),
             f"{what} log weights: kernel vs plain max {float(d.max())}")
    return pose, float(d.max())


def _stats_agree(kernel, plain) -> None:
    """The statistics K2b's last block writes against the twin's: lse and
    lse2 (rtol 1e-5); the MAP particle is the kernel's own highest-index
    maximum, with its log weight and index, and the plain log weight there
    is within 1e-4 + 1e-5 |lw| of the plain maximum; the estimate is the
    MAP particle (lse is finite here)."""
    import torch

    (kp, klw, ks), (_, plw, ps) = kernel, plain
    _require(ks.shape == ps.shape == (10,), "stats shape")
    _require(torch.allclose(ks[:2], ps[:2], rtol=1e-5, atol=1e-4),
             f"lse/lse2 kernel {ks[:2].tolist()} plain {ps[:2].tolist()}")
    i = int(ks[6])
    _require(i == int(torch.nonzero(klw == klw.max()).max()),
             "MAP is not the kernel's highest-index maximum")
    _require(torch.equal(ks[2:5], kp[:, i]) and ks[5] == klw[i],
             "MAP coordinates or log weight")
    _require(bool(torch.isfinite(ks[0])) and torch.equal(ks[7:10], ks[2:5]),
             "estimate")
    top = plw.max()
    _require(float(top - plw[i]) <= 1e-4 + 1e-5 * float(top.abs()),
             "MAP log weight off the plain maximum")


def _pf_cfg(n: int):
    """The main path's PF configuration (``bench_pf_pallas``)."""
    from tpuslam_torch.filters import PfConfig

    return PfConfig(num_particles=n, weight_mode="log",
                    resample_method="merge")


def _gen(dev, seed: int):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def _truth_view(dev):
    """x0 and the landmarks seen from it, float32 on ``dev``."""
    import torch

    from tpuslam_torch.core.se2 import world_to_robot
    from tpuslam_torch.filters import PfConfig

    x0 = torch.tensor(PfConfig().x0, dtype=torch.float32, device=dev)
    lm = torch.tensor(PfConfig().landmarks, dtype=torch.float32, device=dev)
    return x0, world_to_robot(x0, lm).contiguous()


def _rmse(x_true, x_est) -> float:
    import torch

    return float(torch.sqrt(((x_est[:, :2] - x_true[:, :2]) ** 2)
                            .sum(-1).mean()))


def _pf_step_parity(dev) -> float:
    """8. The step kernel against its plain version at
    :data:`PF_STEP_CHECK`: K2b (with and without the reset flag, its
    statistics written by its last block), K2b reading its flags from a
    device gate ``[take, restart]`` (bit-equal to the host flag's launch
    on the same rows, and with ``take`` stepping the other rows), and K2a.
    Returns the largest difference."""
    import torch

    from tpuslam_torch.ops import pf_cuda

    f32 = dict(dtype=torch.float32, device=dev)
    x0, z_true = _truth_view(dev)
    spread = torch.tensor([0.5, 0.5, 0.2], **f32)[:, None]
    err_pose = err_lw = 0.0
    for n, noise_on, with_normals in PF_STEP_CHECK:
        g = _gen(dev, n)
        p_rows = (x0[:, None] + torch.randn((3, n), generator=g, **f32)
                  * spread).contiguous()
        lw = torch.randn(n, generator=g, **f32) * 2.0
        z = (z_true + 0.3 * torch.randn((5, 2), generator=g, **f32))
        normals = (torch.randn((3, n), generator=g, **f32)
                   if with_normals else None)
        by_flag = {}
        for flag, with_stats in ((0.0, True), (1.0, True), (0.0, False)):
            args = (_pf_cfg(n), 12345, flag, p_rows, lw, z.contiguous(),
                    noise_on, normals, with_stats)
            kern = pf_cuda.pf_step_rows(*args)
            plain = pf_cuda.pf_step_rows_plain(*args)
            pose, lw_gap = _step_gap(kern, plain)
            err_pose, err_lw = max(err_pose, pose), max(err_lw, lw_gap)
            if with_stats:
                _stats_agree(kern, plain)
                by_flag[flag] = kern
        other = torch.zeros_like(p_rows)  # the carried rows where take
        for take, restart in ((False, False), (False, True), (True, True)):
            gate = torch.tensor([take, restart], device=dev)
            rows = (other, p_rows) if take else (p_rows, other)
            args = (_pf_cfg(n), 12345, 0.0, rows[0], lw, z.contiguous(),
                    noise_on, normals, True)
            kern = pf_cuda.pf_step_rows(*args, gate=gate, p_alt=rows[1])
            plain = pf_cuda.pf_step_rows_plain(*args, gate=gate,
                                               p_alt=rows[1])
            pose, lw_gap = _step_gap(kern, plain, "gated pf_step")
            err_pose, err_lw = max(err_pose, pose), max(err_lw, lw_gap)
            _stats_agree(kern, plain)
            _require(all(torch.equal(a, b) for a, b in
                         zip(kern, by_flag[float(restart)])),
                     f"gated K2b [{take}, {restart}] differs from its host "
                     f"flag's launch at {n}")
    torch.cuda.synchronize()
    _require(pf_cuda.ticket_count(dev) == 0, "K2b's ticket is not 0")
    shapes = ", ".join(f"{n:,} " + ("normals" if nrm else "Philox" if on
                                    else "noise off")
                       for n, on, nrm in PF_STEP_CHECK)
    print(f"pf_step parity ({shapes}; stats, reset flag, no stats, device "
          f"gate [0,0] [0,1] [1,1] bit-equal to the host flag's): "
          f"max|kernel-plain| poses {err_pose:.3e} (atol 1e-4), log "
          f"weights {err_lw:.3e} (1e-4 + 1e-5|lw|); lse/lse2 rtol 1e-5, MAP "
          f"and estimate by the kernel's rule; ticket 0 after", flush=True)
    return max(err_pose, err_lw)


def _sparse_front(u):
    """Weights ``u`` scaled so that the first 80% hold a tenth of the
    total (a sum of one)."""
    k = int(0.8 * u.shape[0])
    w = u.clone()
    w[:k] *= 0.1 / w[:k].sum()
    w[k:] *= 0.9 / w[k:].sum()
    return w


def _resample_profiles(dev):
    """The flagship count, particle rows and four weight profiles, each
    with its comb offset: ``(n, p_rows, [(name, w, offs), ...])``.  In the
    last the first 80% of the particles share a tenth of the weight, so
    K3b's slot ranges there span more particles than it stages."""
    import torch

    f32 = dict(dtype=torch.float32, device=dev)
    n = PF_SIZES[0]
    g = _gen(dev, 99)
    p_rows = torch.randn((3, n), generator=g, **f32)
    block = torch.zeros(n, **f32)
    block[:400] = 1.0  # 400 survivors in block 0, 128 in each 2048 after
    block.view(-1, 2048)[1:, :128] = 1.0
    profiles = (
        ("heavy-tail", torch.softmax(4.0 * torch.randn(n, generator=g,
                                                       **f32), 0)),
        ("near-uniform", torch.softmax(0.1 * torch.randn(n, generator=g,
                                                         **f32), 0)),
        ("400-in-one-block", block / block.sum()),
        ("sparse-front", _sparse_front(torch.rand(n, generator=g, **f32))))
    return n, p_rows, [(name, w, torch.rand(1, generator=g, **f32))
                       for name, w in profiles]


def _k3_cases(dev):
    """Phase 9's shapes ``(label, n, n_pad)``: the flagship, 100,000, a
    ragged count (not a multiple of 4) and ``n_pad > n``."""
    n = PF_SIZES[0]
    return (("flagship", n, n), ("100,000", 100_000, 100_000),
            ("ragged", 100_003, 100_003), ("n_pad > n", 99_999, 100_352))


def _log_form(w, n: int):
    """``(log_w, lse, lse2)`` of weights ``w`` (lanes from ``n`` on set to
    0, which K3a must ignore): the gated K3a's inputs."""
    import torch

    lw = torch.log(w)
    lw[n:] = 0.0
    return (lw.contiguous(), torch.logsumexp(lw[:n], 0),
            torch.logsumexp(2.0 * lw[:n], 0))


def _gate_cases(lse, lse2, n: int):
    """``(label, lse, lse2, ess_min, want)``: the gate firing, off, bad
    normalizers not firing and bad ones firing (a threshold above n)."""
    import torch

    nan = torch.full_like(lse, float("nan"))
    return (("firing", lse, lse2, float(n), [True, True]),
            ("off", lse, lse2, 0.0, [False, False]),
            ("bad", nan, lse2, float(n), [False, True]),
            ("bad, threshold 2n", lse, nan, 2.0 * n, [True, True]))


def _resample_parity(dev) -> tuple[float, float]:
    """9. K3a in both forms and K3b bit-equal to their plain versions on
    three weight profiles at the flagship count, at 100,000, at a ragged
    count and with ``n_pad > n``: the weights form (``resample_boundary``,
    the public merge's), the gated form on the log weights
    (``gated_boundary``, the rollout's) with its gate equal to the twin's
    expression, K3b ungated and gated, ``merge_resample_rows`` and
    ``merge_resample_gated``.  The gate is held to its twin firing, off
    and with bad normalizers, and a launch with the gate off leaves K3a's
    and K3b's outputs untouched.  Returns the largest |kernel - plain|
    seen on the boundaries and on the rows."""
    import torch

    from tpuslam_torch.ops import resample_cuda as rs

    n_full, p_full, profiles = _resample_profiles(dev)
    seen = []
    err_t = err_rows = 0.0
    for label, n, n_pad in _k3_cases(dev):
        p_rows = p_full[:, :n_pad].contiguous()
        for name, w_full, offs in profiles:
            w = w_full[:n_pad].clone()
            w[n:] = 0.0
            w = (w / w.sum()).contiguous()
            what = f"{label} {name}"
            t_k = rs.resample_boundary(w, n, offs)
            t_p = rs.resample_boundary_plain(w, n, offs)
            err_t = max(err_t, float((t_k - t_p).abs().max()))
            _require(torch.equal(t_k, t_p), f"{what}: boundaries differ")
            lw, lse, lse2 = _log_form(w, n)
            for case, a, b, ess_min, want in _gate_cases(lse, lse2, n):
                t_g, gate = rs.gated_boundary(lw, a, b, n, offs, ess_min)
                t_gp, gate_p = rs.gated_boundary_plain(lw, a, b, n, offs,
                                                       ess_min)
                _require(torch.equal(gate, gate_p)
                         and gate.tolist() == want,
                         f"{what} {case}: gate {gate.tolist()}, twin "
                         f"{gate_p.tolist()}, want {want}")
                if want[0] and case == "firing":
                    err_t = max(err_t, float((t_g - t_gp).abs().max()))
                    _require(torch.equal(t_g, t_gp),
                             f"{what}: gated boundaries differ")
            out_k = rs.resample_expand(p_rows, t_k, n)
            out_p = rs.resample_expand_plain(p_rows, t_p, n)
            err_rows = max(err_rows, float((out_k - out_p).abs().max()))
            _require(torch.equal(out_k, out_p), f"{what}: K3b rows differ")
            merged = rs.merge_resample_rows(p_rows, w, n, offs, device=dev)
            merged_p = rs.merge_resample_rows_plain(p_rows, w, n, offs,
                                                    device=dev)
            _require(torch.equal(merged, out_k)
                     and torch.equal(merged_p, out_k),
                     f"{what}: merge_resample_rows differs")
            gated, gate = rs.merge_resample_gated(p_rows, lw, lse, lse2, n,
                                                  offs, float(n))
            gated_p, _ = rs.merge_resample_gated_plain(p_rows, lw, lse, lse2,
                                                       n, offs, float(n))
            err_rows = max(err_rows, float((gated - gated_p).abs().max()))
            _require(torch.equal(gated, gated_p),
                     f"{what}: the gated merge differs from its twin")
            # The gate off: every launch leaves its output untouched.
            t_out = torch.full_like(t_k, -7)
            rows_out = torch.full_like(p_rows, 123.0)
            _, off = rs.gated_boundary(lw, lse, lse2, n, offs, 0.0,
                                       out=t_out)
            rs.resample_expand(p_rows, t_k, n, gate=off, out=rows_out)
            _require(off.tolist() == [False, False]
                     and bool((t_out == -7).all())
                     and bool((rows_out == 123.0).all()),
                     f"{what}: a launch with the gate off wrote its output")
            if label == "flagship":
                t_lo = torch.cat([t_p.new_zeros(1), t_p[:-1]])
                seen.append(f"{name} {int((t_p > t_lo).sum())} survivors")
    torch.cuda.synchronize()
    _require(rs.boundary_arrivals(dev) == 0,
             "K3a's barrier arrivals are not 0")
    print(f"resample parity at {', '.join(c[0] for c in _k3_cases(dev))} "
          f"(flagship {n_full:,}): K3a given weights and gated on log "
          f"weights, K3b ungated and gated, merge_resample_rows and the "
          f"gated merge bit-equal to plain ({', '.join(seen)}); the gate "
          f"equal to its twin firing, off and with bad normalizers; the gate "
          f"off leaves K3a's and K3b's outputs untouched; max|kernel-plain| "
          f"boundaries {err_t}, rows {err_rows}; K3a's barrier arrivals 0",
          flush=True)
    return err_t, err_rows


def _pf_bands(dev) -> None:
    """10. The Philox noise band of the fused PF."""
    from tpuslam_torch.ops import pf_fused_rollout

    n, steps = PF_BAND_SHAPE
    _, (x_true, x_est) = pf_fused_rollout(_pf_cfg(n), _gen(dev, 3), steps,
                                          device=dev)
    band = _rmse(x_true, x_est)
    _require(PF_BAND[0] < band < PF_BAND[1], f"PF RMSE {band} off-band")
    print(f"pf bands {n:,}x{steps}: rmse {band:.4f} in {PF_BAND}",
          flush=True)


def _pf_main_path(dev) -> tuple[dict, int, object]:
    """11. The main path as bench_pf_pallas runs it; only these launches
    are counted.  The merge gates on the device: K3a and K3b launch every
    step, no host sync (``pf_cuda.sync_count`` and torch's sync debug
    mode, with an ``.item()`` control), K2b's ticket and K3a's barrier
    arrivals at 0
    after.  The steps that fired are read once from the device after the
    rollout (its gates).  Returns the launch counts by kernel name, that
    firing count and the final state."""
    import torch

    from tpuslam_torch.ops import (_build, pf_cuda, pf_fused_rollout,
                                   resample_cuda)
    from tpuslam_torch.utils import count_host_syncs

    with count_host_syncs() as control:
        torch.ones(1, device=dev).item()
    _require(control.count >= 1, "the host-sync counter saw no .item()")
    n = PF_SIZES[0]
    gates = []
    pf_cuda.sync_count = 0
    _build.launches.clear()
    t0 = time.perf_counter()
    with count_host_syncs() as syncs:
        final, (x_true, x_est) = pf_fused_rollout(
            _pf_cfg(n), _gen(dev, 0), PF_STEPS, device=dev, gates=gates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {form: _build.launches[form] for form in (
        "pf_step", "resample_boundary", "resample_boundary_weights",
        "resample_expand")}
    fired = int(torch.stack(gates)[:, 0].sum())
    tickets = (pf_cuda.ticket_count(dev),
               resample_cuda.boundary_arrivals(dev))
    # K3a runs on the gate: its weights form (the public merge's) not once.
    _require(all(v == (0 if k == "resample_boundary_weights" else PF_STEPS)
                 for k, v in launches.items()),
             f"PF main-path launches {launches}")
    _require(pf_cuda.sync_count == 0 and syncs.count == 0,
             f"PF main path: {pf_cuda.sync_count} gate syncs, "
             f"{syncs.count} host syncs")
    _require(tickets == (0, 0),
             f"K2b ticket, K3a arrivals {tickets} after")
    _require(0 < fired < PF_STEPS, f"the gate fired {fired} times")
    _require(final.particles.shape == (n, 3)
             and bool(final.particles.isfinite().all())
             and bool(final.weights.isfinite().all()),
             "PF final state: shape or finiteness")
    rmse = _rmse(x_true, x_est)
    _require(PF_BAND[0] < rmse < PF_BAND[1],
             f"PF main-path RMSE {rmse} off-band")
    print(f"pf_fused_rollout(device='cuda') {n:,}x{PF_STEPS}: rmse "
          f"{rmse:.4f}, launches {launches}, fired {fired} (read once from "
          f"the device after), host syncs {pf_cuda.sync_count} (gate) and "
          f"{syncs.count} (sync debug mode; control .item(): "
          f"{control.count}), K2b ticket and K3a arrivals {tickets} after, "
          f"first call {wall * 1e3:.1f} ms (truth table built)", flush=True)
    return launches, fired, final


def _gated_loop_parity(dev, fired: int, final) -> None:
    """11b. The gated loop against its twin, step by step on the card.
    With Philox noise and phase 11's draws the kernels' steps reproduce
    phase 11's rollout bit for bit (the same final particles); at every
    step the gate and, where it fires, the boundaries and resampled rows
    of the kernels equal the twins' on the kernels' own state, and the
    twins' gate fires as often as phase 11's device count.  With noise off,
    from a spread cloud, the same every step for :data:`PF_STEPS` steps
    with the gate mixed, and K2b's step (from the gate) within its
    tolerance of the twin's."""
    import torch

    from tpuslam_torch.ops import pf_cuda, pf_fused_init
    from tpuslam_torch.ops import resample_cuda as rs

    n = PF_SIZES[0]
    cfg = _pf_cfg(n)
    f32 = dict(dtype=torch.float32, device=dev)
    ess_min = pf_cuda.ess_min(cfg)

    def merge_both(fs, offs):
        args = (fs.particles, fs.log_w, fs.lse, fs.lse2, n, offs, ess_min)
        rows, gate = rs.merge_resample_gated(*args)
        rows_p, gate_p = rs.merge_resample_gated_plain(*args)
        _require(torch.equal(gate, gate_p), f"gate {gate.tolist()} against "
                 f"the twin's {gate_p.tolist()}")
        if bool(gate[0]):
            _require(torch.equal(rows, rows_p), "gated rows differ")
        return bool(gate_p[0])

    # Noise on: phase 11's rollout, its draws made as the rollout makes
    # them (comb offsets, then scaled observation noise).
    g = _gen(dev, 0)
    offs = torch.rand((PF_STEPS,), generator=g, **f32)
    obs = torch.randn((PF_STEPS, 5, 2), generator=g, **f32) * torch.tensor(
        cfg.r_std, **f32)
    fs = pf_fused_init(cfg, device=dev)
    seed, twin_fired = pf_cuda.SEED0, 0
    for k in range(PF_STEPS):
        twin_fired += merge_both(fs, offs[k])
        fs, _ = pf_cuda.pf_fused_step_stats(cfg, fs, None, seed,
                                            offs=offs[k], obs_noise=obs[k])
        seed += pf_cuda.SEED_STEP
    _require(torch.equal(fs.particles.T, final.particles),
             "the stepped rollout left phase 11's path")
    _require(twin_fired == fired, f"the twin's gate fired {twin_fired} "
             f"times, the device's {fired}")

    # Noise off from a spread cloud with random log weights.
    gen = _gen(dev, 5)
    x0, _ = _truth_view(dev)
    spread = torch.tensor([0.5, 0.5, 0.2], **f32)[:, None]
    fs = fs._replace(
        particles=(x0[:, None] + spread * torch.randn((3, n), generator=gen,
                                                      **f32)).contiguous(),
        log_w=2.0 * torch.randn(n, generator=gen, **f32))
    fs = fs._replace(lse=torch.logsumexp(fs.log_w, 0),
                     lse2=torch.logsumexp(2.0 * fs.log_w, 0))
    zero = torch.zeros(5, 2, **f32)
    off_fired, err = 0, 0.0
    for k in range(PF_STEPS):
        off_fired += merge_both(fs, offs[k])
        nxt, _ = pf_cuda.pf_fused_step_stats(cfg, fs, None, 0, False,
                                             offs=offs[k], obs_noise=zero)
        plain, _ = pf_cuda.pf_fused_step_stats_plain(
            cfg, fs, None, 0, False, offs=offs[k], obs_noise=zero)
        err = max(err, *_step_gap((nxt.particles, nxt.log_w, None),
                                  (plain.particles, plain.log_w, None),
                                  "noise-off gated step"))
        fs = nxt
    _require(0 < off_fired < PF_STEPS,
             f"noise off: the gate fired {off_fired} times")
    torch.cuda.synchronize()
    print(f"gated loop against its twin, stepped, {n:,}x{PF_STEPS}: Philox "
          f"(phase 11's draws) reproduces phase 11's final particles bit "
          f"for bit, gate, boundaries and rows bit-equal to the twins' every "
          f"step, twin fired {twin_fired} = device {fired}; noise off from a "
          f"spread cloud: the same, fired {off_fired}, K2b's step "
          f"max|kernel-plain| {err:.3e} (atol 1e-4)", flush=True)


def _pf_timings(dev, smi):
    """12. Rollouts at bench.py's sizes, kernel and plain: CUDA events,
    median of 3 after one warm-up (plain: one call).  Each timed output's
    RMSE is in band, then one Philox step from its final state runs the
    kernels against plain at full width.  Returns the flagship's final
    state and the largest step difference."""
    import torch

    from tpuslam_torch.ops import (pf_fused_init, pf_fused_rollout,
                                   pf_fused_rollout_plain,
                                   pf_fused_step_stats,
                                   pf_fused_step_stats_plain)
    from tpuslam_torch.utils import timed

    err = 0.0
    finals = {}
    for n in PF_SIZES:
        cfg = _pf_cfg(n)
        out = {}

        def call(cfg=cfg, out=out):
            out["k"] = pf_fused_rollout(cfg, _gen(dev, 0), PF_STEPS,
                                        device=dev)

        seconds = timed(call, reps=3, warmup=1, device=dev)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host_step = (time.perf_counter() - t0) / PF_STEPS
        plain_s = timed(lambda cfg=cfg: pf_fused_rollout_plain(
            cfg, _gen(dev, 0), PF_STEPS, device=dev), reps=1, warmup=0,
            device=dev)
        final, (x_true, x_est) = out["k"]
        finals[n] = final
        rmse = _rmse(x_true, x_est)
        _require(PF_BAND[0] < rmse < PF_BAND[1], f"timed {n} RMSE {rmse}")
        fs = pf_fused_init(cfg, final, device=dev)
        step = dict(offs=0.5, obs_noise=torch.zeros(5, 2, device=dev))
        kern, ess = pf_fused_step_stats(cfg, fs, None, 4242, **step)
        plain, _ = pf_fused_step_stats_plain(cfg, fs, None, 4242, **step)
        gap = _step_gap((kern.particles, kern.log_w, None),
                        (plain.particles, plain.log_w, None))
        err = max(err, *gap)
        print(f"timing pf {n:,}x{PF_STEPS}: "
              f"{n * PF_STEPS / seconds:.4e} particle-steps/s "
              f"({seconds * 1e3:.3f} ms, host clock {host_step * 1e6:.1f} "
              f"us a step); plain {n * PF_STEPS / plain_s:.4e} "
              f"({plain_s * 1e3:.3f} ms); rmse {rmse:.4f}; step from the "
              f"final state (ESS {float(ess):.1f}) max|kernel-plain| poses "
              f"{gap[0]:.3e}, log weights {gap[1]:.3e}; on {smi}",
              flush=True)
    return finals[PF_SIZES[0]], err


def _profile(label: str, call, top_n: int = 4,
             steps: int | None = None, levels: int | None = None) -> None:
    """Where one call's time goes (``utils.profile_window``): device busy
    time over host wall time, the largest device-time entries, with
    ``steps`` the torch operations a step and with ``levels`` the kernel
    launches a level, then the program's spans (count, total and self
    time)."""
    from tpuslam_torch.utils import profile_window

    got = profile_window(call, steps)
    wall_ms, busy_ms = got["wall_ms"], got["busy_ms"]
    ops = ("" if steps is None
           else f", {got['ops_per_step']:.1f} torch ops a step")
    if levels:
        ops += (f", {got['launches']} kernel launches "
                f"({got['launches'] / levels:.1f} a level of {levels})")
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), host waiting "
          f"for the device {got['sync_ms']:.3f} ms{ops}; "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in got["top"][:top_n]),
          flush=True)
    if got["spans"]:
        print(f"spans {label}: " + "; ".join(
            f"{k} {v['count']} x, {v['total_ms']:.3f} ms (self "
            f"{v['self_ms']:.3f})" for k, v in got["spans"].items()),
            flush=True)


def _pf_profile(dev) -> None:
    """13. Where a flagship rollout's time goes."""
    from tpuslam_torch.ops import pf_fused_rollout

    n = PF_SIZES[0]
    _profile(f"pf {n:,}x{PF_STEPS}", lambda: pf_fused_rollout(
        _pf_cfg(n), _gen(dev, 0), PF_STEPS, device=dev), steps=PF_STEPS)


def _pf_kernel_times(dev, smi, final, launches: dict, err: float,
                     err_resample: tuple[float, float], fired: int):
    """14. Each kernel alone at the flagship's shapes, on the flagship
    rollout's final state, beside its plain version, its bound and,
    where one PyTorch call computes the same function, that call.  K3a
    and K3b are timed firing (the gate forced on) and idle (off); K3a
    also on given weights, the public merge's form.  Returns the
    kernels' entries of the ``kernels`` line."""
    import torch

    from tpuslam_torch.ops import pf_cuda, pf_fused_init
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import device_ms

    n = PF_SIZES[0]
    cfg = _pf_cfg(n)
    fs = pf_fused_init(cfg, final, device=dev)
    p_rows, lw = fs.particles, fs.log_w
    offs = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    on = (lw, fs.lse, fs.lse2, n, offs, float(n))
    idle = on[:-1] + (0.0,)
    w = torch.exp(lw - fs.lse)
    t_hi, gate = rs.gated_boundary(*on)
    _, gate_off = rs.gated_boundary(*idle)
    _require(gate.tolist() == [True, True]
             and gate_off.tolist() == [False, False], "forced gates")
    counts = torch.diff(t_hi, prepend=t_hi.new_zeros(1)).to(torch.int64)
    step_args = (cfg, 1, 0.0, p_rows, lw, _truth_view(dev)[1])
    k3a_bound = _bound(8 * n + 16, K5A_OPS * n)
    kernels = [
        ("pf_step", "tpuslam_torch/csrc/pf_step.cu",
         "tpuslam/ops/pf_pallas.py:144",
         lambda: pf_cuda.pf_step_rows(*step_args),
         lambda: pf_cuda.pf_step_rows_plain(*step_args), None,
         _bound(32 * n + 40 + 4 * pf_cuda._STATS_LEN, PF_STEP_OPS * n), err,
         launches["pf_step"]),
        ("resample_boundary", "tpuslam_torch/csrc/resample.cu",
         "tpuslam/ops/resample_pallas.py:883",
         lambda: rs.gated_boundary(*on),
         lambda: rs.gated_boundary_plain(*on), None, k3a_bound,
         err_resample[0], launches["resample_boundary"]),
        ("resample_boundary_weights", "tpuslam_torch/csrc/resample.cu",
         "tpuslam/ops/resample_pallas.py:883",
         lambda: rs.resample_boundary(w, n, offs),
         lambda: rs.resample_boundary_plain(w, n, offs), None,
         _bound(8 * n + 4, (K5A_OPS - 2) * n), err_resample[0],
         launches["resample_boundary_weights"]),
        ("resample_expand", "tpuslam_torch/csrc/resample.cu",
         "tpuslam/ops/resample_pallas.py:235",
         lambda: rs.resample_expand(p_rows, t_hi, n, gate=gate),
         lambda: rs.resample_expand_plain(p_rows, t_hi, n),
         lambda: torch.repeat_interleave(p_rows, counts, dim=1,
                                         output_size=n),
         _bound(28 * n, 0), err_resample[1], launches["resample_expand"]),
    ]
    entries = []
    for name, src, replaces, fn, plain_fn, lib_fn, bound, max_err, \
            count in kernels:
        ms = device_ms(fn, 50)
        plain_ms = device_ms(plain_fn, 5)
        library_ms = None if lib_fn is None else device_ms(lib_fn, 20)
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": count,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms})
        print(f"kernel {name} at {n:,}: {ms:.4f} ms a launch, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})"
              + ("" if library_ms is None
                 else f", torch.repeat_interleave {library_ms:.4f} ms")
              + f"; {count} launches in the main path"
              + (f" ({fired} firing)" if name.startswith("resample_")
                 and count else "") + f"; on {smi}", flush=True)
    # The gate off: every block exits after reading it.
    ms_a = device_ms(lambda: rs.gated_boundary(*idle), 50)
    ms_b = device_ms(lambda: rs.resample_expand(p_rows, t_hi, n,
                                                gate=gate_off), 50)
    print(f"kernel resample_boundary idle (gate off) at {n:,}: {ms_a:.4f} "
          f"ms a launch; resample_expand idle {ms_b:.4f} ms; on {smi}",
          flush=True)
    # K3b where a few particles take most slots (phase 9's heavy tail).
    _, _, profiles = _resample_profiles(dev)
    w_heavy, offs_heavy = profiles[0][1], profiles[0][2]
    t_heavy = rs.resample_boundary(w_heavy, n, offs_heavy)
    top = int(torch.diff(t_heavy, prepend=t_heavy.new_zeros(1)).max())
    ms_h = device_ms(lambda: rs.resample_expand(p_rows, t_heavy, n), 50)
    print(f"kernel resample_expand at {n:,}, {profiles[0][0]} weights (one "
          f"particle takes {top:,} slots): {ms_h:.4f} ms a launch; on {smi}",
          flush=True)
    # The same kernel without the reductions (K2a), which the convenience
    # call pf_fused_predict_weight launches; the main path does not.
    ms = device_ms(lambda: pf_cuda.pf_step_rows(*step_args,
                                                 with_stats=False), 50)
    plain_ms = device_ms(lambda: pf_cuda.pf_step_rows_plain(
        *step_args, with_stats=False), 5)
    bound = _bound(32 * n + 40, (PF_STEP_OPS - 5) * n)
    print(f"kernel pf_step without stats at {n:,}: {ms:.4f} ms a launch, "
          f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
          f"on {smi}", flush=True)
    return entries


def _pf_phases(dev, smi):
    """The PF path's phases, in order; returns its kernels' entries and
    the main path's firing steps."""
    err_step = _pf_step_parity(dev)
    err_resample = _resample_parity(dev)
    _pf_bands(dev)
    launches, fired, main_final = _pf_main_path(dev)
    _gated_loop_parity(dev, fired, main_final)
    final, err_timed = _pf_timings(dev, smi)
    _pf_profile(dev)
    return _pf_kernel_times(dev, smi, final, launches,
                            max(err_step, err_timed), err_resample,
                            fired), fired


# ---------------------------------------------------------------------------
# The batched and the wide particle filters (K4, K5a, the segmented K3b,
# K5b).
# ---------------------------------------------------------------------------

def _batch_cfg(n: int, frac: float = 0.01):
    """The batched paths' configuration (``bench_pf_batch`` and
    ``bench_pf_batch_wide``: log weights, the default gate)."""
    from tpuslam_torch.filters import PfConfig

    return PfConfig(num_particles=n, weight_mode="log",
                    ess_threshold_frac=frac)


def _batch_inputs(dev, b: int, n: int, seed: int):
    """A spread cloud around x0 for every filter, log weights whose spread
    grows with the filter index (ESS from about 0.9 n down to about
    0.02 n), their normalizers and one noisy observation a filter."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb

    f32 = dict(dtype=torch.float32, device=dev)
    g = _gen(dev, seed)
    x0, z_true = _truth_view(dev)
    spread = torch.tensor([0.5, 0.5, 0.2], **f32)[:, None, None]
    particles = (x0[:, None, None] + spread
                 * torch.randn((3, b, n), generator=g, **f32)).contiguous()
    sigma = torch.linspace(0.3, 2.0, b, **f32)[:, None]
    log_w = (sigma * torch.randn((b, n), generator=g, **f32)).contiguous()
    z = (z_true + 0.3 * torch.randn((b, 5, 2), generator=g, **f32))
    st = pb.pf_batch_refresh_stats(_batch_cfg(n), pb.PfBatchState(
        x0, particles, log_w, None, None))
    return particles, log_w, st.lse, st.lse2, z.contiguous(), g


def _map_agrees(kp, klw, k_est, plw, what: str) -> None:
    """Each filter's MAP is the kernel's own highest-index maximum, and
    the plain log weight there is within 1e-4 + 1e-5 |lw| of the plain
    maximum (rounding may reorder near-ties between the two)."""
    import torch

    n = klw.shape[-1]
    idx = torch.arange(n, device=klw.device)
    best = torch.where(klw == klw.max(dim=-1, keepdim=True).values, idx,
                       -1).max(dim=-1).values
    pick = torch.take_along_dim(kp, best[None, :, None], dim=2)[..., 0].T
    _require(torch.equal(pick, k_est), f"{what}: MAP coordinates")
    top = plw.max(dim=-1).values
    at = torch.take_along_dim(plw, best[:, None], dim=1)[:, 0]
    _require(bool((top - at <= 1e-4 + 1e-5 * top.abs()).all()),
             f"{what}: MAP log weight off the plain maximum")


def _batch_parity(dev):
    """15. K4 against its twin, one step at 8192 x 1000 and at the
    :data:`BATCH_RAGGED` shapes: the gate closed (ess_threshold_frac 1e-3),
    forced (2.0) and natural (0.3, a mixed gate), each with injected
    normals and comb offsets and with Philox, and noise off with the gate
    closed and forced; selection bit-equal.  Returns the largest
    difference."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb

    f32 = dict(dtype=torch.float32, device=dev)
    worst = 0.0
    for b, n in (BATCH_MAIN,) + BATCH_RAGGED:
        particles, log_w, lse, lse2, z, g = _batch_inputs(dev, b, n, 15)
        normals = torch.randn((3, b, n), generator=g, **f32)
        offs = torch.rand(b, generator=g, **f32)
        lines = []
        for gate, frac, fired_range in (("closed", 1e-3, (0, 0)),
                                        ("forced", 2.0, (b, b)),
                                        ("natural", 0.3, (1, b - 1))):
            for noise, noise_on, nrm, off in (
                    ("noise off", False, None, None),
                    ("injected normals and offsets", True, normals, offs),
                    ("Philox", True, None, None)):
                if gate == "natural" and not noise_on:
                    continue
                label = f"{b}x{n} {gate} {noise}"
                args = (_batch_cfg(n, frac), 777, particles, log_w, lse,
                        lse2, z, noise_on, nrm, off)
                kern = pb.pf_batch_step_rows(*args, with_sel=True)
                plain = pb.pf_batch_step_rows_plain(*args, with_sel=True)
                _require(torch.equal(kern.resampled, plain.resampled)
                         and torch.equal(kern.bad, plain.bad),
                         f"K4 {label}: gate flags differ")
                _require(torch.equal(kern.ess, plain.ess),
                         f"K4 {label}: ESS")
                fired = int(kern.resampled.sum())
                _require(fired_range[0] <= fired <= fired_range[1],
                         f"K4 {label}: {fired} of {b} fired")
                _require(torch.equal(kern.sel, plain.sel),
                         f"K4 {label}: selection differs")
                pose, lw_gap = _step_gap((kern.particles, kern.log_w, None),
                                         (plain.particles, plain.log_w,
                                          None), f"K4 {label}")
                _require(torch.allclose(kern.lse, plain.lse, rtol=1e-5,
                                        atol=1e-4)
                         and torch.allclose(kern.lse2, plain.lse2,
                                            rtol=1e-5, atol=1e-4),
                         f"K4 {label}: lse/lse2")
                _map_agrees(kern.particles, kern.log_w, kern.x_est,
                            plain.log_w, f"K4 {label}")
                worst = max(worst, pose, lw_gap)
                lines.append(f"{gate} {noise}: {fired} fired, poses "
                             f"{pose:.3e}, log weights {lw_gap:.3e}")
        torch.cuda.synchronize()
        print(f"pf_batch (K4) parity at {b:,}x{n:,}, selection bit-equal: "
              + "; ".join(lines) + " (atol 1e-4 poses, 1e-4 + 1e-5|lw|)",
              flush=True)
    return worst


def _wide_inputs(dev, b: int, n: int, seed: int):
    """Wide inputs: a spread cloud, skewed log weights and their
    normalizers, an observation a filter, a fifth of the filters firing
    (every fifth) and a twentieth bad (NaN normalizers, none firing)."""
    import torch

    particles, log_w, lse, lse2, z, g = _batch_inputs(dev, b, n, seed)
    f32 = dict(dtype=torch.float32, device=dev)
    ids = torch.arange(b, device=dev)
    fire = ids % 5 == 0
    bad = ids % 20 == 3
    offs = torch.rand(b, generator=g, **f32)
    return particles, log_w, lse, lse2, z, fire, bad, offs


def _boundary_held(pb, args, what: str) -> float:
    """K5a against its twin on ``args`` (log weights, normalizers, gate,
    offsets): the slots bit for bit, the valid slots' boundaries bit for
    bit.  Returns the largest boundary difference (0)."""
    import torch

    k = pb.wide_boundary(*args)
    p = pb.wide_boundary_plain(*args)
    for name in ("fids", "valid", "src"):
        _require(torch.equal(getattr(k, name), getattr(p, name)),
                 f"K5a {what}: {name} differs from the twin")
    v = p.valid
    err = float((k.t_hi[v] - p.t_hi[v]).abs().max()) if bool(v.any()) \
        else 0.0
    _require(torch.equal(k.t_hi[v], p.t_hi[v]),
             f"K5a {what}: boundaries differ from the twin (max {err})")
    return err


def _wide_resample_parity(dev, smi):
    """16. K5a bit-equal to its twin (slots and boundaries) at
    1024 x 10,000 with :data:`EXPAND_FIRING` filters firing, each timed
    (its fixed cost against its cost a firing filter), and at
    :data:`BOUNDARY_EDGES`; then K5a and the segmented K3b on phase 16's
    wide inputs (a fifth firing), the expanded rows bit-equal to the
    twin's.  Returns the largest differences."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import device_ms
    from tpuslam_torch.utils.turns import seg_inputs

    b, n = WIDE_MAIN
    err_t = 0.0
    times = []
    for n_fire in EXPAND_FIRING:
        args = seg_inputs(dev, b, n, n_fire)[1:]
        err_t = max(err_t, _boundary_held(pb, args, f"{b}x{n}, {n_fire} "
                                          "firing"))
        times.append(device_ms(lambda: pb.wide_boundary(*args), 20))
    per_fire = (times[-1] - times[0]) / EXPAND_FIRING[-1]
    print(f"K5a at {b:,}x{n:,}: " + ", ".join(
        f"{f} firing {t:.4f} ms" for f, t in zip(EXPAND_FIRING, times))
        + f" a launch ({times[0]:.4f} ms fixed, {1e3 * per_fire:.4f} us a "
        f"firing filter); slots and boundaries bit-equal to plain at each; "
        f"on {smi}", flush=True)
    for eb, en, n_fire, one in BOUNDARY_EDGES:
        args = seg_inputs(dev, eb, en, n_fire, 17, one)[1:]
        err_t = max(err_t, _boundary_held(
            pb, args, f"{eb}x{en}, {n_fire} firing, one survivor {one}"))

    particles, log_w, lse, _, _, fire, _, offs = _wide_inputs(dev, b, n, 16)
    args = (log_w, lse, fire, offs)
    err_t = max(err_t, _boundary_held(pb, args, f"{b}x{n}, a fifth"))
    sl = pb.wide_boundary(*args)
    v = sl.valid
    ex_k = rs.resample_expand_seg(particles, sl.t_hi, sl.fids, v)
    ex_p = rs.resample_expand_seg_plain(particles, sl.t_hi, sl.fids, v)
    err_rows = float((ex_k[:, v] - ex_p[:, v]).abs().max())
    _require(torch.equal(ex_k[:, v], ex_p[:, v]), "expanded rows differ")
    n_fire = int(v.sum())
    t_v = sl.t_hi[v]
    t_lo = torch.cat([t_v[:, :1] * 0, t_v[:, :-1]], dim=1)
    srv = int((t_v > t_lo).sum())
    torch.cuda.synchronize()
    print("K5a bit-equal to plain at " + ", ".join(
        f"{eb:,}x{en:,} ({n_fire_e} firing"
        + (", one particle holding each filter's weight)" if one else ")")
        for eb, en, n_fire_e, one in BOUNDARY_EDGES)
        + f"; wide resample (K5a + segmented K3b) at {b:,}x{n:,}: "
        f"{n_fire} of {b} filters firing, {srv:,} survivors; boundaries "
        f"and expanded rows bit-equal to plain (max|kernel-plain| {err_t}, "
        f"{err_rows})", flush=True)
    return err_t, err_rows


def _expand_seg_checks(dev, smi) -> None:
    """16b. The segmented K3b bit-equal to its twin on the valid slots at
    :data:`WIDE_MAIN` with :data:`EXPAND_FIRING` filters firing, each
    timed alone (its fixed cost against its cost a firing filter), and
    at :data:`EXPAND_EDGES` and with its boundaries in a view off 16-byte
    alignment, on ``turns.seg_args``' clouds and weights."""
    import torch

    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import device_ms
    from tpuslam_torch.utils.turns import seg_args

    def held(args, what):
        v = args[3]
        k = rs.resample_expand_seg(*args)
        p = rs.resample_expand_seg_plain(*args)
        _require(torch.equal(k[:, v], p[:, v]),
                 f"segmented K3b differs from its twin: {what}")

    b, n = WIDE_MAIN
    times = []
    for n_fire in EXPAND_FIRING:
        args = seg_args(dev, b, n, n_fire)
        held(args, f"{b}x{n}, {n_fire} firing")
        times.append(f"{n_fire} firing "
                     f"{device_ms(lambda: rs.resample_expand_seg(*args), 20):.4f}"
                     " ms")
    print(f"segmented K3b at {b:,}x{n:,}: " + ", ".join(times)
          + f" a launch; bit-equal to plain at each; on {smi}", flush=True)
    for b, n, one in EXPAND_EDGES:
        held(seg_args(dev, b, n, b, 17, one), f"{b}x{n}, one survivor "
             f"{one}")
    # Boundaries in a contiguous view 4 bytes past a 16-byte boundary: the
    # kernel takes its scalar loads there.
    b, n = WIDE_MAIN
    particles, t_hi, fids, valid = seg_args(dev, b, n, b, 17)
    shifted = torch.empty(t_hi.numel() + 1, dtype=t_hi.dtype,
                          device=dev)[1:].view_as(t_hi).copy_(t_hi)
    _require(shifted.data_ptr() % 16 != 0, "the shifted view is aligned")
    held((particles, shifted, fids, valid), f"{b}x{n}, shifted boundaries")
    torch.cuda.synchronize()
    print("segmented K3b bit-equal to plain, every filter firing, at "
          + ", ".join(f"{b:,}x{n:,}" + (" one survivor a filter" if one
                                        else "")
                      for b, n, one in EXPAND_EDGES)
          + f", and {b:,}x{n:,} with its boundaries 4 bytes off 16-byte "
          "alignment", flush=True)


def _wide_stats_parity(dev):
    """17. K5b against its twin at 1024 x 10,000 and at
    :data:`WIDE_RAGGED`: the fused form (the main path's) with the gate
    closed (no filter fires), forced (every filter) and natural (a fifth
    fire, a twentieth are bad), each with injected normals and with
    Philox; on the natural gate also noise off and the unfused form.
    Poses and log weights at the step tolerances, the filter's lse and
    lse2 at rtol 1e-5 (their sums are taken in another order), the MAP
    the kernel's own highest-index maximum, and the next step's gate that
    the kernel writes (the rollout's only gate after its first step)
    ``_gate`` of the kernel's lse and lse2 bit for bit, its bad flags the
    twin's.  Returns the largest difference."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs

    f32 = dict(dtype=torch.float32, device=dev)
    worst = 0.0
    for b, n in (WIDE_MAIN,) + WIDE_RAGGED:
        particles, log_w, lse, _, z, natural, bad, offs = _wide_inputs(
            dev, b, n, 17)
        normals = torch.randn((3, b, n), generator=_gen(dev, 170 + b), **f32)
        ids = torch.arange(b, device=dev)
        cfg = _batch_cfg(n)
        lines = []
        for gate, fire in (("closed", ids < 0), ("forced", ids >= 0),
                           ("natural", natural)):
            slots = pb.wide_boundary(log_w, lse, fire, offs)
            fused = (slots.src,
                     rs.resample_expand_seg(particles, slots.t_hi,
                                            slots.fids, slots.valid))
            runs = [("fused normals", fused, True, normals),
                    ("fused Philox", fused, True, None)]
            if gate == "natural":
                runs += [("fused noise off", fused, False, None),
                         ("unfused Philox", (None, None), True, None),
                         ("unfused noise off", (None, None), False, None)]
            for form, extra, noise_on, nrm in runs:
                label = f"{b}x{n} {gate} {form}"
                args = (cfg, 4242, particles, log_w, z, bad, fire, *extra,
                        noise_on, nrm)
                kern = pb.wide_stats_rows(*args)
                plain = pb.wide_stats_rows_plain(*args)
                pose, lw_gap = _step_gap(kern[:2] + (None,),
                                         plain[:2] + (None,), f"K5b {label}")
                _require(torch.allclose(kern[2], plain[2], rtol=1e-5,
                                        atol=1e-4)
                         and torch.allclose(kern[3], plain[3], rtol=1e-5,
                                            atol=1e-4),
                         f"K5b {label}: lse/lse2")
                _map_agrees(kern[0], kern[1], kern[4], plain[1],
                            f"K5b {label}")
                want = pb._gate(cfg, kern[2], kern[3])
                _require(torch.equal(kern[5][0], want[0])
                         and torch.equal(kern[5][2], want[2])
                         and torch.equal(kern[5][1].view(torch.int32),
                                         want[1].view(torch.int32))
                         and torch.equal(kern[5][0], plain[5][0]),
                         f"K5b {label}: the next step's gate")
                worst = max(worst, pose, lw_gap)
                lines.append(f"{gate} {form} poses {pose:.3e}, log weights "
                             f"{lw_gap:.3e}")
        torch.cuda.synchronize()
        print(f"wide stats (K5b) parity at {b:,}x{n:,}, lse/lse2, MAP "
              f"and the next step's gate (bit-equal to torch's of those "
              f"normalizers) written by the kernel: " + "; ".join(lines)
              + " (atol 1e-4 poses, 1e-4 + 1e-5|lw|)", flush=True)
    return worst


def _batch_rmse(outs) -> float:
    import torch

    e = outs.x_est[..., :2] - outs.x_true[:, None, :2]
    return float(torch.sqrt((e ** 2).sum(-1).mean()))


def _batch_bands(dev) -> None:
    """18. The Philox bands of the batched and wide paths (bench.py:476-488:
    256 x 1000 x 100 and 32 x 10,000 x 100)."""
    from tpuslam_torch.ops import pf_batch_rollout, pf_batch_wide_rollout

    got = []
    for label, fn, (b, n, steps), seed in (
            ("batched", pf_batch_rollout, BATCH_BAND_SHAPE, 4),
            ("wide", pf_batch_wide_rollout, WIDE_BAND_SHAPE, 5)):
        _, outs = fn(_batch_cfg(n), _gen(dev, seed), b, steps, device=dev)
        rmse = _batch_rmse(outs)
        _require(BATCH_BAND[0] < rmse < BATCH_BAND[1],
                 f"{label} RMSE {rmse} off-band")
        got.append(f"{label} {b}x{n:,}x{steps} rmse {rmse:.4f}")
    print("pf batch bands: " + ", ".join(got) + f" in {BATCH_BAND}",
          flush=True)


def _batch_main_paths(dev) -> dict:
    """19. The two main paths through the user's calls at the JAX
    package's full widths, with the launch counts set to 0 just before
    each and read just after, and the host synchronisations counted by
    torch's sync debug mode.  Returns the launch counts by kernel."""
    import torch

    from tpuslam_torch.ops import (_build, pf_batch_rollout,
                                   pf_batch_wide_rollout)
    from tpuslam_torch.utils import count_host_syncs

    with count_host_syncs() as control:
        torch.ones(1, device=dev).item()
    _require(control.count >= 1, "the host-sync counter saw no .item()")

    launches = {}
    _build.launches.clear()
    div0 = _build.div_fallbacks(dev)
    t0 = time.perf_counter()
    b, n = BATCH_MAIN
    with count_host_syncs() as syncs:
        final, outs = pf_batch_rollout(_batch_cfg(n), _gen(dev, 0), b,
                                       PF_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["pf_batch_step"] = _build.launches["pf_batch_step"]
    _require(launches["pf_batch_step"] == PF_STEPS,
             f"K4 launches {launches['pf_batch_step']}")
    div1 = _build.div_fallbacks(dev)
    _require(div1 == div0, f"batched path: IEEE quotient passes {div0} -> "
             f"{div1}")
    _require(syncs.count == 0, f"batched path: {syncs.count} host syncs")
    _require(final.particles.shape == (3, b, n)
             and bool(final.particles.isfinite().all())
             and bool(final.lse.isfinite().all()),
             "batched final state: shape or finiteness")
    rmse = _batch_rmse(outs)
    _require(BATCH_BAND[0] < rmse < BATCH_BAND[1],
             f"batched main-path RMSE {rmse} off-band")
    fired = float(outs.resampled.float().mean())
    print(f"pf_batch_rollout(device='cuda') {b:,}x{n:,}x{PF_STEPS}: rmse "
          f"{rmse:.4f}, K4 launches {launches['pf_batch_step']}, host syncs "
          f"{syncs.count} (control .item(): {control.count}), IEEE quotient "
          f"passes 0, filters firing a step {100 * fired:.1f}%, first call "
          f"{wall * 1e3:.1f} ms", flush=True)

    _build.launches.clear()
    t0 = time.perf_counter()
    b, n = WIDE_MAIN
    with count_host_syncs() as syncs:
        final, outs = pf_batch_wide_rollout(_batch_cfg(n), _gen(dev, 0), b,
                                            PF_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wide = {form: _build.launches[form] for form in (
        "wide_boundary", "resample_expand_seg", "wide_stats")}
    launches.update(wide)
    div2 = _build.div_fallbacks(dev)
    _require(div2 == div1, f"wide path: IEEE quotient passes {div1} -> "
             f"{div2}")
    _require(wide["wide_boundary"] == wide["resample_expand_seg"]
             == wide["wide_stats"] == PF_STEPS, f"wide launches {wide}")
    _require(syncs.count == 0, f"wide path: {syncs.count} host syncs")
    _require(final.particles.shape == (3, b, n)
             and bool(final.particles.isfinite().all())
             and bool(final.lse.isfinite().all()),
             "wide final state: shape or finiteness")
    rmse = _batch_rmse(outs)
    _require(BATCH_BAND[0] < rmse < BATCH_BAND[1],
             f"wide main-path RMSE {rmse} off-band")
    fired = float(outs.resampled.float().mean())
    print(f"pf_batch_wide_rollout(device='cuda') {b:,}x{n:,}x{PF_STEPS}: "
          f"rmse {rmse:.4f}, launches {wide}, host syncs {syncs.count}, "
          f"filters firing a step {100 * fired:.1f}%, first call "
          f"{wall * 1e3:.1f} ms", flush=True)
    return launches


def _batch_timings(dev, smi) -> dict:
    """20. Both rollouts at bench.py's sizes: CUDA events, median of 3
    after one warm-up, each timed output's RMSE in band.  Returns the
    final states at the main paths' shapes."""
    import torch

    from tpuslam_torch.ops import pf_batch_rollout, pf_batch_wide_rollout
    from tpuslam_torch.utils import timed

    finals = {}
    for label, fn, sizes in (("batched", pf_batch_rollout, BATCH_SIZES),
                             ("wide", pf_batch_wide_rollout, WIDE_SIZES)):
        for b, n in sizes:
            out = {}

            def call(fn=fn, b=b, n=n, out=out):
                out["k"] = fn(_batch_cfg(n), _gen(dev, 0), b, PF_STEPS,
                              device=dev)

            seconds = timed(call, reps=3, warmup=1, device=dev)
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            host_step = (time.perf_counter() - t0) / PF_STEPS
            final, outs = out["k"]
            finals[(label, b, n)] = final
            rmse = _batch_rmse(outs)
            _require(BATCH_BAND[0] < rmse < BATCH_BAND[1],
                     f"timed {label} {b}x{n} RMSE {rmse}")
            print(f"timing pf {label} {b:,}x{n:,}x{PF_STEPS}: "
                  f"{b * n * PF_STEPS / seconds:.4e} particle-steps/s "
                  f"({seconds * 1e3:.3f} ms, host clock "
                  f"{host_step * 1e6:.1f} us a step); rmse {rmse:.4f}; "
                  f"firing {100 * float(outs.resampled.float().mean()):.1f}%"
                  f"; on {smi}", flush=True)
    return finals


def _batch_profiles(dev) -> None:
    """21. Where a main-path rollout's time goes, each path."""
    from tpuslam_torch.ops import pf_batch_rollout, pf_batch_wide_rollout

    for label, fn, (b, n) in (("batched", pf_batch_rollout, BATCH_MAIN),
                              ("wide", pf_batch_wide_rollout, WIDE_MAIN)):
        _profile(f"pf {label} {b:,}x{n:,}x{PF_STEPS}",
                 lambda fn=fn, b=b, n=n: fn(_batch_cfg(n), _gen(dev, 0), b,
                                            PF_STEPS, device=dev), top_n=6,
                 steps=PF_STEPS)


def _batch_kernel_times(dev, smi, finals, launches, errs) -> list:
    """22. K4, K5a, the segmented K3b and K5b alone at the main paths'
    shapes, on the states those rollouts reached, beside their twins,
    their bounds and, for the expand, ``torch.repeat_interleave``.
    Returns their entries of the ``kernels`` line."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import device_ms

    f32 = dict(dtype=torch.float32, device=dev)
    g = _gen(dev, 21)
    _, z_true = _truth_view(dev)

    b, n = BATCH_MAIN
    st = finals[("batched", b, n)]
    cfg = _batch_cfg(n)
    z = (z_true + 0.3 * torch.randn((b, 5, 2), generator=g, **f32))
    k4_args = (cfg, 1, st.particles, st.log_w, st.lse, st.lse2,
               z.contiguous())
    k4_fire = int(pb._gate(cfg, st.lse, st.lse2)[2].sum())

    b_w, n_w = WIDE_MAIN
    sw = finals[("wide", b_w, n_w)]
    cfg_w = _batch_cfg(n_w)
    bad, _, fire = pb._gate(cfg_w, sw.lse, sw.lse2)
    offs = torch.rand(b_w, generator=g, **f32)
    k5a_args = (sw.log_w, sw.lse, fire, offs)
    slots = pb.wide_boundary(*k5a_args)
    t_hi = slots.t_hi
    expanded = rs.resample_expand_seg(sw.particles, t_hi, slots.fids,
                                      slots.valid)
    zw = (z_true + 0.3 * torch.randn((b_w, 5, 2), generator=g, **f32))
    k5b_args = (cfg_w, 1, sw.particles, sw.log_w, zw.contiguous(), bad,
                fire, slots.src, expanded)
    n_fire = int(fire.sum())
    v = slots.valid
    rows = sw.particles[:, slots.fids[v].long()].reshape(3, -1).contiguous()
    counts = torch.diff(t_hi[v], dim=1,
                        prepend=t_hi.new_zeros((n_fire, 1))).reshape(-1)
    counts = counts.to(torch.int64)
    lanes_fire = n_fire * n_w
    # K4's float work a particle of a firing filter: exp, shift, scale,
    # round, the boundary law's two multiplies, subtract, ceil and clip.
    ops_fire = 10

    kernels = [
        ("pf_batch_step", "tpuslam_torch/csrc/pf_batch.cu",
         "tpuslam/ops/pf_batch_pallas.py:190",
         lambda: pb.pf_batch_step_rows(*k4_args),
         lambda: pb.pf_batch_step_rows_plain(*k4_args), None,
         _bound(32 * b * n + 80 * b,
                PF_STEP_OPS * b * n + ops_fire * k4_fire * n),
         errs["pf_batch_step"], f"{b:,}x{n:,}, {k4_fire} firing"),
        ("wide_boundary", "tpuslam_torch/csrc/pf_wide.cu",
         "tpuslam/ops/pf_batch_pallas.py:762",
         lambda: pb.wide_boundary(*k5a_args),
         lambda: pb.wide_boundary_plain(*k5a_args), None,
         _bound(8 * lanes_fire + 8 * n_fire + 10 * b_w, K5A_OPS * lanes_fire),
         errs["wide_boundary"], f"{b_w:,}x{n_w:,}, {n_fire} firing"),
        ("resample_expand_seg", "tpuslam_torch/csrc/resample.cu",
         "tpuslam/ops/resample_pallas.py:235",
         lambda: rs.resample_expand_seg(sw.particles, t_hi, slots.fids, v),
         lambda: rs.resample_expand_seg_plain(sw.particles, t_hi,
                                              slots.fids, v),
         lambda: torch.repeat_interleave(rows, counts, dim=1,
                                         output_size=lanes_fire),
         _bound(28 * lanes_fire + 5 * b_w, 0), errs["resample_expand_seg"],
         f"{b_w:,}x{n_w:,}, {n_fire} firing"),
        ("wide_stats", "tpuslam_torch/csrc/pf_wide.cu",
         "tpuslam/ops/pf_batch_pallas.py:876",
         lambda: pb.wide_stats_rows(*k5b_args),
         lambda: pb.wide_stats_rows_plain(*k5b_args), None,
         _bound(28 * b_w * n_w + 4 * (b_w - n_fire) * n_w + 72 * b_w,
                PF_STEP_OPS * b_w * n_w),
         errs["wide_stats"], f"{b_w:,}x{n_w:,}, {n_fire} firing"),
    ]
    entries = []
    for name, src, replaces, fn, plain_fn, lib_fn, bound, max_err, shape \
            in kernels:
        ms = device_ms(fn, 20)
        plain_ms = device_ms(plain_fn, 3)
        library_ms = None if lib_fn is None else device_ms(lib_fn, 20)
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms})
        print(f"kernel {name} at {shape}: {ms:.4f} ms a launch"
              + f", plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})"
              + ("" if library_ms is None
                 else f", torch.repeat_interleave {library_ms:.4f} ms")
              + f"; {launches[name]} launches in the main path; on {smi}",
              flush=True)
    return entries


def _batch_phases(dev, smi):
    """The batched and wide paths' phases, in order; returns their
    kernels' entries."""
    errs = {"pf_batch_step": _batch_parity(dev)}
    errs["wide_boundary"], errs["resample_expand_seg"] = \
        _wide_resample_parity(dev, smi)
    _expand_seg_checks(dev, smi)
    errs["wide_stats"] = _wide_stats_parity(dev)
    _batch_bands(dev)
    launches = _batch_main_paths(dev)
    finals = _batch_timings(dev, smi)
    _batch_profiles(dev)
    return _batch_kernel_times(dev, smi, finals, launches, errs)


# ---------------------------------------------------------------------------
# The merge's compressed path (K3c, K3d and their segmented forms).
# ---------------------------------------------------------------------------

def _max_gap(pairs) -> float:
    """The largest |a - b| over pairs of equal-shaped tensors (0 where
    they are empty)."""
    return max((float((a - b).abs().max()) for a, b in pairs if a.numel()),
               default=0.0)


def _stack_held(rs, p_rows, t, n: int, what: str) -> tuple[float, float]:
    """The single K3c's stack and counts and K3d's rows (a block a range
    of output slots) bit-equal to their twins and K3d's rows to K3b's, on
    rows ``p_rows`` and boundaries ``t``.  Returns the largest |kernel -
    plain| of each and the survivors."""
    import torch

    stack = rs.compact_particles(p_rows, t)
    stack_p = rs.compact_particles_plain(p_rows, t)
    err_c = _max_gap(zip(stack, stack_p))
    _require(all(torch.equal(a, b) for a, b in zip(stack, stack_p)),
             f"{what}: K3c stack or counts differ")
    out = rs.expand_compressed(*stack[:2], n, cnt=stack[2])
    out_p = rs.expand_compressed_plain(*stack[:2], n)
    err_d = _max_gap([(out, out_p)])
    _require(torch.equal(out, out_p), f"{what}: K3d rows differ")
    _require(torch.equal(out, rs.resample_expand(p_rows, t, n)),
             f"{what}: K3d differs from K3b")
    return err_c, err_d, int(stack[2].sum())


def _merge_paths_parity(dev) -> tuple[float, float]:
    """23. The merge's compressed path at the flagship count on phase 9's
    weight profiles (the heavy tail, near-uniform, 400 survivors in one
    block and the sparse front): K3c's stack and counts and K3d's rows
    equal their twins bit for bit, and K3b's rows; both ``pass2`` merges
    equal the default, and so do both gated merges; with the gate off K3c
    writes zero counts only and K3d nothing.  Then the single forms at
    100,003 particles in 100,352 lanes, and K3c with its boundaries in a
    view 4 bytes off 16-byte alignment.  Returns the largest |kernel -
    plain| of K3c and of K3d."""
    import torch

    from tpuslam_torch.ops import resample_cuda as rs

    n, p_rows, profiles = _resample_profiles(dev)
    err_c = err_d = 0.0
    seen = []
    for name, w, offs in profiles:
        t_k = rs.resample_boundary(w, n, offs)
        ec, ed, survivors = _stack_held(rs, p_rows, t_k, n, name)
        err_c, err_d = max(err_c, ec), max(err_d, ed)
        default = rs.merge_resample_rows(p_rows, w, n, offs, device=dev)
        lw, lse, lse2 = _log_form(w, n)
        gated = {}
        for pass2 in rs.PASS2:
            got = rs.merge_resample_rows(p_rows, w, n, offs, device=dev,
                                         pass2=pass2)
            _require(torch.equal(got, default),
                     f"{name}: merge pass2={pass2} differs")
            gated[pass2], _ = rs.merge_resample_gated(
                p_rows, lw, lse, lse2, n, offs, float(n), pass2=pass2)
        _require(torch.equal(gated["compressed"], gated["windowed"]),
                 f"{name}: the gated merges differ")
        _, off = rs.gated_boundary(lw, lse, lse2, n, offs, 0.0)
        stack = rs.compact_particles(p_rows, t_k, gate=off)
        _require(not bool(stack[2].any()),
                 f"{name}: K3c counted with the gate off")
        # The stack is stale where the gate is off: K3d must not read it.
        rs.expand_compressed(*stack[:2], n, cnt=stack[2], gate=off)
        seen.append(f"{name} {survivors:,} survivors")
    # n_pad > n: lanes [n, n_pad) carry n and must come out zero.
    n_r, n_pad = 100_003, 100_352
    g = _gen(dev, 23)
    w = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    w[:n_r] = torch.softmax(4.0 * torch.randn(n_r, generator=g, device=dev),
                            0)
    p_r = torch.randn((3, n_pad), generator=g, device=dev)
    t_r = rs.resample_boundary(w, n_r, torch.rand(1, generator=g,
                                                  device=dev))
    ec, ed, _ = _stack_held(rs, p_r, t_r, n_r, f"{n_r:,} in {n_pad:,}")
    # Boundaries in a view 4 bytes past a 16-byte boundary: K3c's scalar
    # loads.
    shifted = torch.empty(n_pad + 1, dtype=torch.int32,
                          device=dev)[1:].copy_(t_r)
    _require(shifted.data_ptr() % 16 != 0, "the shifted view is aligned")
    ec2, ed2, _ = _stack_held(rs, p_r, shifted, n_r, "shifted boundaries")
    err_c, err_d = max(err_c, ec, ec2), max(err_d, ed, ed2)
    torch.cuda.synchronize()
    print(f"merge paths parity at {n:,}: K3c stack and counts and K3d rows "
          f"bit-equal to plain and K3d to K3b, both pass2 merges equal the "
          f"default, both gated merges equal, K3c's counts 0 with the gate "
          f"off ({', '.join(seen)}); the same K3c and K3d at {n_r:,} in "
          f"{n_pad:,} lanes and with the boundaries 4 bytes off 16-byte "
          f"alignment; max|kernel-plain| K3c {err_c}, K3d {err_d}",
          flush=True)
    return err_c, err_d


def _seg_stack_held(rs, args, what: str) -> tuple[float, float, int]:
    """The segmented K3c's stack (valid slots) and counts and K3d's rows
    (a block a window of stack blocks and a slot; valid slots) bit-equal
    to their twins and K3d's rows to the segmented K3b's, on ``args``
    ``(particles, t_hi, fids, valid)``.  Returns the largest |kernel -
    plain| of each and the survivors."""
    import torch

    v = args[3]
    vals, iv, cnt = rs.compact_particles_seg(*args)
    vals_p, iv_p, cnt_p = rs.compact_particles_seg_plain(*args)
    pairs = [(vals[:, v], vals_p[:, v]), (iv[:, v], iv_p[:, v]),
             (cnt, cnt_p)]
    err_c = _max_gap(pairs)
    _require(all(torch.equal(a, c) for a, c in pairs),
             f"segmented K3c stack or counts differ: {what}")
    ex = rs.expand_compressed_seg(vals, iv, v, cnt=cnt)
    ex_p = rs.expand_compressed_seg_plain(vals, iv, v)
    err_d = _max_gap([(ex[:, v], ex_p[:, v])])
    _require(torch.equal(ex[:, v], ex_p[:, v]),
             f"segmented K3d rows differ: {what}")
    _require(torch.equal(ex[:, v], rs.resample_expand_seg(*args)[:, v]),
             f"segmented K3d differs from the segmented K3b: {what}")
    return err_c, err_d, int(cnt.sum())


def _wide_compressed_parity(dev) -> tuple[float, float]:
    """24. The segmented K3c and K3d bit-equal to their twins at
    1024 x 10,000 on phase 16's inputs (a fifth of the filters firing),
    their rows equal to the segmented K3b's; the same on phase 16b's
    (``turns.seg_args``): :data:`EXPAND_FIRING` filters firing of
    1024 x 10,000, :data:`EXPAND_EDGES` (64 x 10,001, 8 x 100,000, one
    survivor a filter), and the boundaries in a view 4 bytes off 16-byte
    alignment; then one whole wide step with ``pass2="compressed"`` equal
    to the windowed step bit for bit.  Returns the largest |kernel -
    plain| of each."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils.turns import seg_args

    b, n = WIDE_MAIN
    f32 = dict(dtype=torch.float32, device=dev)
    particles, log_w, lse, lse2, _, fire, _, offs = _wide_inputs(dev, b, n,
                                                                 16)
    slots = pb.wide_boundary(log_w, lse, fire, offs)
    v = slots.valid
    err_c, err_d, survivors = _seg_stack_held(
        rs, (particles, slots.t_hi, slots.fids, v), "phase 16's inputs")
    cases = [(seg_args(dev, b, n, n_fire), f"{b}x{n}, {n_fire} firing")
             for n_fire in EXPAND_FIRING]
    cases += [(seg_args(dev, bb, nn, bb, 17, one),
               f"{bb}x{nn}, one survivor {one}")
              for bb, nn, one in EXPAND_EDGES]
    args = seg_args(dev, b, n, b, 17)
    shifted = torch.empty(args[1].numel() + 1, dtype=args[1].dtype,
                          device=dev)[1:].view_as(args[1]).copy_(args[1])
    _require(shifted.data_ptr() % 16 != 0, "the shifted view is aligned")
    cases.append(((args[0], shifted, *args[2:]),
                  f"{b}x{n}, shifted boundaries"))
    for case, what in cases:
        ec, ed, _ = _seg_stack_held(rs, case, what)
        err_c, err_d = max(err_c, ec), max(err_d, ed)

    x0, _ = _truth_view(dev)
    state = pb.PfBatchWideState(x0, particles, log_w, lse, lse2,
                                x0.expand(b, 3).contiguous())
    cfg = _batch_cfg(n, WIDE_STEP_FRAC)
    kw = dict(obs_noise=torch.zeros((b, 5, 2), **f32), offs=offs)
    st_w, out_w = pb.pf_batch_wide_step(cfg, state, None, 4242, **kw)
    st_c, out_c = pb.pf_batch_wide_step(cfg, state, None, 4242,
                                        pass2="compressed", **kw)
    for name in ("particles", "log_w", "lse", "lse2", "x_est"):
        _require(torch.equal(getattr(st_w, name), getattr(st_c, name)),
                 f"compressed wide step: {name} differs from the windowed")
    fired = int(out_c.resampled.sum())
    _require(0 < fired < b and torch.equal(out_w.resampled, out_c.resampled),
             f"compressed wide step: {fired} of {b} fired")
    torch.cuda.synchronize()
    print(f"wide compressed pass B (segmented K3c + K3d) parity at "
          f"{b:,}x{n:,}: {int(v.sum())} of {b} filters firing, "
          f"{survivors:,} survivors; stack, counts and rows bit-equal to "
          f"plain and to the segmented K3b, and so at "
          f"{'; '.join(what for _, what in cases)} (max|kernel-plain| "
          f"{err_c}, {err_d}); one Philox step with {fired} firing: "
          f"particles, log weights, normalizers and x_est of "
          f"pass2='compressed' equal the windowed step's", flush=True)
    return err_c, err_d


def _merge_main_paths(dev, default_fired: int) -> dict:
    """25. The compressed paths through the user's calls, the counts set to
    0 just before each and read just after: ``pf_fused_rollout`` with
    :data:`MERGE_KW` at 2,097,152 x 400 (K3a, K3c and K3d every step, on
    the device's gate, which fires as often as in phase 11; no K3b; 0 host
    syncs) and ``pf_batch_wide_rollout(pass2="compressed")`` at
    1024 x 10,000 x 400 (400 launches each of the segmented K3c and K3d, no
    segmented K3b, 0 host syncs).  Returns the launch counts."""
    import torch

    from tpuslam_torch.ops import (_build, pf_batch_wide_rollout, pf_cuda,
                                   pf_fused_rollout)
    from tpuslam_torch.utils import count_host_syncs

    with count_host_syncs() as control:
        torch.ones(1, device=dev).item()
    _require(control.count >= 1, "the host-sync counter saw no .item()")
    n = PF_SIZES[0]
    gates = []
    pf_cuda.sync_count = 0
    _build.launches.clear()
    with count_host_syncs() as syncs:
        final, (x_true, x_est) = pf_fused_rollout(
            _pf_cfg(n), _gen(dev, 0), PF_STEPS, device=dev,
            merge_caps_kw=MERGE_KW, gates=gates)
    torch.cuda.synchronize()
    single = {form: _build.launches[form] for form in (
        "pf_step", "resample_boundary", "resample_expand", "compact",
        "expand_compressed")}
    fired = int(torch.stack(gates)[:, 0].sum())
    _require(single["resample_boundary"] == single["compact"]
             == single["expand_compressed"] == single["pf_step"] == PF_STEPS
             and single["resample_expand"] == 0 and fired == default_fired,
             f"compressed PF launches {single}, fired {fired}, default "
             f"fired {default_fired}")
    _require(pf_cuda.sync_count == 0 and syncs.count == 0,
             f"compressed PF: {pf_cuda.sync_count} gate syncs, "
             f"{syncs.count} host syncs")
    _require(bool(final.particles.isfinite().all()), "PF final state")
    rmse = _rmse(x_true, x_est)
    _require(PF_BAND[0] < rmse < PF_BAND[1], f"compressed PF RMSE {rmse}")
    print(f"pf_fused_rollout(device='cuda', merge_caps_kw={MERGE_KW}) "
          f"{n:,}x{PF_STEPS}: rmse {rmse:.4f}, launches {single}, fired "
          f"{fired} (phase 11: {default_fired}), host syncs "
          f"{syncs.count}", flush=True)
    b, n = WIDE_MAIN
    _build.launches.clear()
    with count_host_syncs() as syncs:
        final, outs = pf_batch_wide_rollout(_batch_cfg(n), _gen(dev, 0), b,
                                            PF_STEPS, device=dev,
                                            pass2="compressed")
    torch.cuda.synchronize()
    wide = {form: _build.launches[form] for form in (
        "wide_boundary", "resample_expand_seg", "compact_seg",
        "expand_compressed_seg", "wide_stats")}
    _require(wide["compact_seg"] == wide["expand_compressed_seg"]
             == wide["wide_boundary"] == wide["wide_stats"] == PF_STEPS
             and wide["resample_expand_seg"] == 0,
             f"compressed wide launches {wide}")
    _require(syncs.count == 0, f"compressed wide: {syncs.count} host syncs")
    _require(bool(final.particles.isfinite().all())
             and bool(final.lse.isfinite().all()), "wide final state")
    rmse = _batch_rmse(outs)
    _require(BATCH_BAND[0] < rmse < BATCH_BAND[1],
             f"compressed wide RMSE {rmse}")
    print(f"pf_batch_wide_rollout(device='cuda', pass2='compressed') "
          f"{b:,}x{n:,}x{PF_STEPS}: rmse {rmse:.4f}, launches {wide}, host "
          f"syncs {syncs.count} (control .item(): {control.count})",
          flush=True)
    return {**single, **wide}


def _merge_timings(dev, smi) -> dict:
    """26. Both compressed main paths beside their default twins, in this
    call, in turns (default, compressed, compressed, default; each turn
    the median of 3 by CUDA events after one warm-up); the final
    particles and the estimates of the two forms equal bit for bit; then
    where a compressed rollout's time goes.  Returns the compressed runs'
    final states."""
    import torch

    from tpuslam_torch.ops import pf_batch_wide_rollout, pf_fused_rollout
    from tpuslam_torch.utils import timed

    n = PF_SIZES[0]
    b, n_w = WIDE_MAIN
    runs = (
        (f"pf {n:,}x{PF_STEPS}", n * PF_STEPS,
         lambda **kw: pf_fused_rollout(_pf_cfg(n), _gen(dev, 0), PF_STEPS,
                                       device=dev, **kw),
         {"merge_caps_kw": MERGE_KW}),
        (f"wide {b:,}x{n_w:,}x{PF_STEPS}", b * n_w * PF_STEPS,
         lambda **kw: pf_batch_wide_rollout(_batch_cfg(n_w), _gen(dev, 0),
                                            b, PF_STEPS, device=dev, **kw),
         {"pass2": "compressed"}))
    finals = []
    for label, work, fn, kw in runs:
        out, secs = {}, {"default": [], "compressed": []}
        forms = {"default": {}, "compressed": kw}
        # In turns (default, compressed, compressed, default), so a drift
        # of the host within the call shows as a gap between each form's
        # two medians rather than between the forms.
        for form in ("default", "compressed", "compressed", "default"):
            def call(form=form):
                out[form] = fn(**forms[form])

            secs[form].append(timed(call, reps=3, warmup=1, device=dev))
        (fin_d, traj_d), (fin_c, traj_c) = out["default"], out["compressed"]
        _require(torch.equal(fin_d.particles, fin_c.particles)
                 and torch.equal(traj_d[1], traj_c[1]),
                 f"timed {label}: compressed differs from the default")
        finals.append(fin_c)
        mean = {form: sum(s) / len(s) for form, s in secs.items()}
        print(f"timing merge paths {label}: default "
              f"{work / mean['default']:.4e} particle-steps/s (medians "
              f"{secs['default'][0] * 1e3:.3f}, "
              f"{secs['default'][1] * 1e3:.3f} ms), compressed "
              f"{work / mean['compressed']:.4e} (medians "
              f"{secs['compressed'][0] * 1e3:.3f}, "
              f"{secs['compressed'][1] * 1e3:.3f} ms); final particles and "
              f"estimates equal; on {smi}", flush=True)
        _profile(f"{label} compressed", lambda fn=fn, kw=kw: fn(**kw),
                 top_n=6)
    return finals


def _merge_kernel_times(dev, smi, finals, launches, errs) -> list:
    """27. K3c, K3d and their segmented forms alone at the main paths'
    shapes, on the states the compressed rollouts reached, beside their
    twins, their bounds and one library call each: boolean-mask
    compaction ``rows[:, flags]`` (which also compresses, and synchronises
    with the host) for K3c, ``torch.repeat_interleave`` of the stack by
    ``t_hi - t_lo`` (0 for its inert columns) for K3d; each form idle too
    (the single filter's gate off, no slot firing).  Returns their entries
    of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import pf_fused_init
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import device_ms

    f32 = dict(dtype=torch.float32, device=dev)
    n = PF_SIZES[0]
    fs = pf_fused_init(_pf_cfg(n), finals[0], device=dev)
    p_rows = fs.particles
    t_hi = rs.slot_boundaries(torch.exp(fs.log_w - fs.lse), n,
                              torch.full((1,), 0.5, **f32))
    vals, iv, cnt = rs.compact_particles(p_rows, t_hi)
    survivors = int(cnt.sum())
    flags = t_hi > F.pad(t_hi[:-1], (1, 0))
    counts = (iv[1] - iv[0]).to(torch.int64)
    blocks = -(-n // rs.BLOCK)

    b, n_w = WIDE_MAIN
    sw = finals[1]
    _, _, fire = pb._gate(_batch_cfg(n_w), sw.lse, sw.lse2)
    slots = pb.wide_boundary(sw.log_w, sw.lse, fire,
                             torch.rand(b, generator=_gen(dev, 27), **f32))
    t_w = slots.t_hi
    v = slots.valid
    seg_args = (sw.particles, t_w, slots.fids, v)
    vals_w, iv_w, cnt_w = rs.compact_particles_seg(*seg_args)
    n_fire = int(v.sum())
    survivors_w = int(cnt_w[v].sum())
    lanes_fire = n_fire * n_w
    rows = sw.particles[:, slots.fids[v].long()].reshape(3, -1)
    t_rows = t_w[v]
    flags_w = (t_rows > F.pad(t_rows[:, :-1], (1, 0))).reshape(-1)
    stack_rows = vals_w[:, v].reshape(3, -1)
    counts_w = (iv_w[1] - iv_w[0])[v].reshape(-1).to(torch.int64)
    blocks_w = -(-n_w // rs.BLOCK)
    at_single = f"{n:,}, {survivors:,} survivors"
    at_wide = f"{b:,}x{n_w:,}, {n_fire} firing, {survivors_w:,} survivors"

    off = torch.zeros(2, dtype=torch.bool, device=dev)
    v_idle = torch.zeros_like(v)
    idle = {
        "compact": lambda: rs.compact_particles(p_rows, t_hi, gate=off),
        "expand_compressed": lambda: rs.expand_compressed(
            vals, iv, n, cnt=cnt, gate=off),
        "compact_seg": lambda: rs.compact_particles_seg(
            sw.particles, t_w, slots.fids, v_idle),
        "expand_compressed_seg": lambda: rs.expand_compressed_seg(
            vals_w, iv_w, v_idle, cnt=cnt_w)}
    kernels = [
        ("compact", "tpuslam/ops/resample_pallas.py:203",
         lambda: rs.compact_particles(p_rows, t_hi),
         lambda: rs.compact_particles_plain(p_rows, t_hi),
         ("boolean-mask compaction", lambda: p_rows[:, flags]),
         _bound(24 * n + 12 * survivors + 4 * blocks, 0), errs["compact"],
         at_single),
        ("expand_compressed", "tpuslam/ops/resample_pallas.py:489",
         lambda: rs.expand_compressed(vals, iv, n, cnt=cnt),
         lambda: rs.expand_compressed_plain(vals, iv, n),
         ("torch.repeat_interleave",
          lambda: torch.repeat_interleave(vals, counts, dim=1,
                                          output_size=n)),
         _bound(20 * survivors + 12 * n + 1, 0), errs["expand_compressed"],
         at_single),
        ("compact_seg", "tpuslam/ops/resample_pallas.py:203",
         lambda: rs.compact_particles_seg(*seg_args),
         lambda: rs.compact_particles_seg_plain(*seg_args),
         ("boolean-mask compaction", lambda: rows[:, flags_w]),
         _bound(24 * lanes_fire + 12 * survivors_w + 4 * b * blocks_w
                + 5 * b, 0), errs["compact_seg"], at_wide),
        ("expand_compressed_seg", "tpuslam/ops/resample_pallas.py:489",
         lambda: rs.expand_compressed_seg(vals_w, iv_w, v, cnt=cnt_w),
         lambda: rs.expand_compressed_seg_plain(vals_w, iv_w, v),
         ("torch.repeat_interleave",
          lambda: torch.repeat_interleave(stack_rows, counts_w, dim=1,
                                          output_size=lanes_fire)),
         _bound(20 * survivors_w + 12 * lanes_fire + b, 0),
         errs["expand_compressed_seg"], at_wide),
    ]
    entries = []
    for name, replaces, fn, plain_fn, (lib_name, lib_fn), bound, max_err, \
            shape in kernels:
        ms = device_ms(fn, 50)
        idle_ms = device_ms(idle[name], 50)
        plain_ms = device_ms(plain_fn, 5)
        library_ms = device_ms(lib_fn, 20)
        entries.append({
            "name": name, "route": "cuda",
            "source": "tpuslam_torch/csrc/resample.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms})
        print(f"kernel {name} at {shape}: {ms:.4f} ms a launch ({idle_ms:.4f} "
              f"idle), plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
              f"{lib_name} {library_ms:.4f} ms; {launches[name]} launches "
              f"in the main path; on {smi}", flush=True)
    return entries


def _merge_phases(dev, smi, default_fired: int):
    """The merge's compressed path's phases, in order; returns its
    kernels' entries."""
    t0 = time.perf_counter()
    errs = {}
    errs["compact"], errs["expand_compressed"] = _merge_paths_parity(dev)
    errs["compact_seg"], errs["expand_compressed_seg"] = \
        _wide_compressed_parity(dev)
    launches = _merge_main_paths(dev, default_fired)
    finals = _merge_timings(dev, smi)
    entries = _merge_kernel_times(dev, smi, finals, launches, errs)
    print(f"merge-path phases 23-27: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return entries


def _cast_traj(traj, dtype=None, device=None):
    """The trajectory's float tensors in ``dtype`` on ``device``."""
    from tpuslam_torch.slam import GraphObservations, SlamTrajectory

    def mv(t):
        return t.to(device=device, dtype=dtype if t.is_floating_point()
                    else t.dtype)

    return SlamTrajectory(mv(traj.poses_actu), mv(traj.poses_odom),
                          GraphObservations(*map(mv, traj.obs)),
                          GraphObservations(*map(mv, traj.obs_true)))


def _seed_traj(traj, k: int):
    """Seed ``k`` of a batched trajectory."""
    from tpuslam_torch.slam import GraphObservations, SlamTrajectory

    return SlamTrajectory(traj.poses_actu[k], traj.poses_odom[k],
                          GraphObservations(*(t[k] for t in traj.obs)),
                          GraphObservations(*(t[k] for t in traj.obs_true)))


def _graph_parity(dev) -> None:
    """28. One seed of the reference course: the f32 frames on the card
    against f64 on the card and f32 on the CPU, on the same observations;
    each frame whose ``is_calc`` differs is printed with its conds."""
    import torch

    from tpuslam_torch.slam import (SlamSceneConfig, estimate_frames,
                                    reference_course_config, simulate)

    cfg = reference_course_config(GRAPH_FRAMES)
    traj = simulate(SlamSceneConfig(), cfg,
                    torch.Generator(device=dev).manual_seed(7),
                    GRAPH_FRAMES, device=dev)
    p32, f32 = estimate_frames(cfg, traj)
    p64, f64 = estimate_frames(cfg, _cast_traj(traj, torch.float64))
    pcpu, fcpu = estimate_frames(cfg, _cast_traj(traj, device="cpu"))
    for p in (p32, p64, pcpu):
        _require(p.shape == (GRAPH_FRAMES + 1, 3)
                 and bool(p.isfinite().all()), "graph poses")
    err64 = float((p32.double() - p64).abs().max())
    err_cpu = float((p32.cpu() - pcpu).abs().max())
    _require(err64 <= GRAPH_ATOL, f"graph f32 against f64: {err64}")
    _require(err_cpu <= GRAPH_ATOL, f"graph card against CPU: {err_cpu}")
    flips = []
    for name, other in (("f64", f64), ("cpu", fcpu)):
        differ = (f32.is_calc.cpu() != other.is_calc.cpu()).nonzero()
        flips += [f"frame {int(k) + 1} against {name}: is_calc "
                  f"{bool(f32.is_calc[k])}/{bool(other.is_calc[k])}, cond "
                  f"{float(f32.cond[k]):.4e}/{float(other.cond[k]):.4e}"
                  for k in differ[:, 0]]
    iters_equal = (torch.equal(f32.gn_iters.cpu(), f64.gn_iters.cpu()),
                   torch.equal(f32.gn_iters.cpu(), fcpu.gn_iters.cpu()))
    print(f"graph parity, reference course {GRAPH_FRAMES} frames, guard "
          f"full: f32 on the card against f64 max|dpose| {err64:.3e}, "
          f"against f32 on the CPU {err_cpu:.3e} (atol {GRAPH_ATOL}); "
          f"is_calc {int(f32.is_calc.sum())}/{GRAPH_FRAMES} frames; gn_iters "
          f"equal to f64 {iters_equal[0]}, to the CPU {iters_equal[1]}; "
          f"is_calc differs: {'; '.join(flips) if flips else 'nowhere'}",
          flush=True)


def _course_stats(cfg, traj, poses, frames):
    """Per seed: position RMSE at observed times, total and largest
    per-frame GN iterations (capped), guard failures
    (tests/test_distributional.py::_graph_course_stats)."""
    import torch

    from tpuslam_torch.slam import observed_times_mask

    mask = observed_times_mask(traj.obs)
    e2 = ((poses[..., :2] - traj.poses_actu[..., :2]) ** 2).sum(-1)
    rmse = torch.sqrt(torch.where(mask, e2, 0.0).sum(-1) / mask.sum(-1))
    iters = frames.gn_iters.clamp(max=cfg.max_gn_iters)
    return {"rmse_pos": rmse.double().cpu(),
            "total_gn_iters": iters.sum(-1).double().cpu(),
            "max_frame_iters": iters.amax(-1).double().cpu(),
            "calc_failures": (~frames.is_calc).sum(-1).double().cpu()}


def _band_check(section: str, stats: dict, bands: dict) -> list:
    """``tests/test_distributional.py``'s check of each statistic against
    the reference's band (the failures' mean only); returns the
    failures."""
    ref_all, n_ref = bands[section], bands[section]["n_seeds"]
    bad = []
    for name, ours in stats.items():
        ours = ours.numpy()
        ref = ref_all[name]
        m, s = float(ours.mean()), float(ours.std(ddof=1))
        tol = K_SIGMA * math.sqrt(ref["std"] ** 2 / n_ref + s ** 2 / ours.size)
        if name == "calc_failures":
            tol = max(tol, 1.0)
        elif ref["std"] > 1e-12 and s > 1e-12 and not (
                1.0 / STD_RATIO <= s / ref["std"] <= STD_RATIO):
            bad.append(f"{name} std ratio {s / ref['std']:.2f}")
        if abs(m - ref["mean"]) > tol:
            bad.append(f"{name} mean {m:.4f} vs {ref['mean']:.4f} +- "
                       f"{tol:.4f}")
    return bad


def _stats_line(stats: dict) -> str:
    return ", ".join(f"{k} {float(v.mean()):.4f} (std {float(v.std()):.4f})"
                     for k, v in stats.items())


def _graph_batched(dev, smi) -> None:
    """29-30. The reference course over GRAPH_SEEDS seeds in one batch,
    with each guard: a warm-up call and a timed one (CUDA events around
    the whole rollout), which must agree bit for bit (with the full
    guard the warm-up and a repeat run at GRAPH_REPEAT_SEEDS and agree
    bit for bit, and the timed call alone runs GRAPH_SEEDS); GN passes and host
    syncs of the timed call; the first seeds solved alone, which must
    iterate as in the batch; one GN pass profiled (and, with the cheap
    guard, the whole rollout); the statistics against the
    reference's bands (the full guard's first 100 seeds held to "graph";
    the cheap guard's printed beside it), then GRAPH_FAST_SEEDS of the
    6-frame course held to "graph_fast"."""
    import torch

    from tpuslam_torch.slam import (SlamSceneConfig, estimate_frames,
                                    gn_iteration, reference_course_config,
                                    slam_rollout, upper_pairs)
    from tpuslam_torch.utils import count_host_syncs

    with open(BANDS_FILE) as f:
        bands = json.load(f)
    scene = SlamSceneConfig()
    for guard in ("full", "cheap"):
        cfg = reference_course_config(GRAPH_FRAMES, guard=guard)

        def run(cfg=cfg, seeds=GRAPH_SEEDS):
            return slam_rollout(scene, cfg,
                                torch.Generator(device=dev).manual_seed(2026),
                                GRAPH_FRAMES, device=dev, seeds=seeds)

        # The warm-up doubles as the repeat check; with the full guard
        # both run at GRAPH_REPEAT_SEEDS (the looped SVD makes a
        # 1024-seed rollout take about 105 s) and the timed call alone
        # keeps GRAPH_SEEDS.
        n_repeat = GRAPH_REPEAT_SEEDS if guard == "full" else GRAPH_SEEDS
        first = run(seeds=n_repeat)
        if n_repeat != GRAPH_SEEDS:
            again = run(seeds=n_repeat)
            _require(torch.equal(first[1], again[1])
                     and torch.equal(first[2].gn_iters, again[2].gn_iters),
                     f"graph {guard}: a repeat run changed the poses")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with count_host_syncs() as syncs:
            start.record()
            traj, poses, frames = run()
            end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if n_repeat == GRAPH_SEEDS:
            _require(torch.equal(first[1], poses)
                     and torch.equal(first[2].gn_iters, frames.gn_iters),
                     f"graph {guard}: a repeat run changed the poses")
        passes = int(frames.gn_iters.amax(dim=0).sum())
        stats = _course_stats(cfg, traj, poses, frames)
        band = {k: v[:GRAPH_BAND_SEEDS] for k, v in stats.items()}
        bad = _band_check("graph", band, bands)
        if guard == "full":
            _require(not bad, f"graph band: {bad}")
        # The cheap guard lets structurally singular frames through (the
        # JAX package's does too, on the same observations): a few
        # courses run away.
        n_away = int((stats["rmse_pos"] > 10.0).sum())
        # The first seeds alone must get what the batch gave them (held
        # with the full guard; the cheap one lets singular frames through,
        # whose updates rounding decides).
        alone, same = [], True
        for k in range(GRAPH_ALONE):
            p1, f1 = estimate_frames(cfg, _seed_traj(traj, k))
            same &= (torch.equal(f1.gn_iters, frames.gn_iters[k])
                     and torch.equal(f1.is_calc, frames.is_calc[k]))
            alone.append(float((p1 - poses[k]).abs().max()))
        if guard == "full":
            _require(same and max(alone) <= GRAPH_ATOL,
                     f"graph seeds alone: {same}, {alone}")
        print(f"graph batched {GRAPH_SEEDS}x{GRAPH_FRAMES} frames, guard "
              f"{guard}: {ms:.3f} ms a rollout "
              f"({GRAPH_SEEDS * GRAPH_FRAMES / ms * 1e3:.4e} seed-frames/s), "
              f"{passes} GN passes "
              f"({ms / passes:.3f} ms a pass), {syncs.count} host syncs; "
              f"repeat at {n_repeat} seeds bit-equal; seeds "
              f"0-{GRAPH_ALONE - 1} alone: is_calc "
              f"and gn_iters {'equal' if same else 'differ'}, max|dpose| "
              f"{max(alone):.3e}; "
              f"{n_away} of {GRAPH_SEEDS} seeds with a "
              f"position RMSE above 10 m; first {GRAPH_BAND_SEEDS} seeds "
              f"{_stats_line(band)}: "
              f"{'; '.join(bad) if bad else 'in the graph band'}; on {smi}",
              flush=True)
        # One GN pass of the last frame, profiled: every pass does the same
        # work.  The whole rollout is profiled with the cheap guard only;
        # the full guard's looped SVD makes too many events.
        pairs = upper_pairs(GRAPH_FRAMES + 1, dev)
        with count_host_syncs() as pass_syncs:
            gn_iteration(cfg, poses, traj.obs, GRAPH_FRAMES, *pairs)
        print(f"graph one GN pass of {GRAPH_SEEDS} seeds, guard {guard}: "
              f"{pass_syncs.count} host syncs inside gn_iteration", flush=True)
        _profile(f"graph one GN pass {GRAPH_SEEDS} seeds guard {guard}",
                 lambda: gn_iteration(cfg, poses, traj.obs, GRAPH_FRAMES,
                                      *pairs), top_n=6)
        if guard == "cheap":
            _profile(f"graph batched {GRAPH_SEEDS}x{GRAPH_FRAMES} guard "
                     f"{guard}", run, top_n=6)
    n_fast = bands["graph_fast_frames"]
    cfg = reference_course_config(n_fast)
    traj, poses, frames = slam_rollout(
        scene, cfg, torch.Generator(device=dev).manual_seed(5150), n_fast,
        device=dev, seeds=GRAPH_FAST_SEEDS)
    stats = _course_stats(cfg, traj, poses, frames)
    bad = _band_check("graph_fast", stats, bands)
    _require(not bad, f"graph_fast band: {bad}")
    print(f"graph batched {GRAPH_FAST_SEEDS}x{n_fast} frames, guard full: "
          f"{_stats_line(stats)}: in the graph_fast band", flush=True)


def _graph_long(dev, smi) -> None:
    """31. One full-history solve of the course at each GRAPH_LONG length:
    f32 timed (CUDA events) and held to f64 on the same observations,
    both calculable."""
    import torch

    from tpuslam_torch.slam import (SlamSceneConfig, graph_solve,
                                    reference_course_config, simulate)

    for steps, guard in GRAPH_LONG:
        cfg = reference_course_config(steps, guard=guard)
        traj = simulate(SlamSceneConfig(), cfg,
                        torch.Generator(device=dev).manual_seed(2), steps,
                        device=dev)
        out = {}
        for dtype in (torch.float32, torch.float64):
            t = _cast_traj(traj, dtype)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = graph_solve(cfg, t.poses_odom, t.obs)
            end.record()
            end.synchronize()
            err = res.poses[:, :2] - t.poses_actu[:, :2]
            rmse = float(torch.sqrt((err ** 2).sum(-1).mean()))
            out[dtype] = res
            print(f"graph solve {steps} steps ({steps + 1} poses), guard "
                  f"{guard}, {str(dtype)[6:]}: {start.elapsed_time(end):.3f}"
                  f" ms, is_calc {bool(res.is_calc)}, {int(res.gn_iters)} GN"
                  f" iterations, delta_sum {float(res.delta_sum):.4e}, cond "
                  f"{float(res.cond):.4e}, rmse {rmse:.4f} m; on {smi}",
                  flush=True)
            _require(bool(res.is_calc), f"graph {steps} {dtype}: not calc")
        gap = float((out[torch.float32].poses.double()
                     - out[torch.float64].poses).abs().max())
        _require(gap <= GRAPH_ATOL, f"graph {steps}: f32 against f64 {gap}")
        print(f"graph solve {steps} steps: f32 against f64 max|dpose| "
              f"{gap:.3e} (atol {GRAPH_ATOL})", flush=True)


def _graph_phases(dev, smi) -> None:
    """Dense graph SLAM's phases, in order (no kernel of its own)."""
    t0 = time.perf_counter()
    _graph_parity(dev)
    _graph_batched(dev, smi)
    _graph_long(dev, smi)
    print(f"graph phases 28-31: {time.perf_counter() - t0:.1f} s",
          flush=True)


def _large_cfg(n_poses: int, n_landmarks: int, max_gn_iters: int = 10):
    """``bench_graph_large``'s GraphConfig (bench.py:206-211)."""
    from tpuslam_torch.models.scan_sensor import ScanConfig
    from tpuslam_torch.slam import GraphConfig

    return GraphConfig(
        max_times=n_poses, num_landmarks=n_landmarks,
        max_gn_iters=max_gn_iters,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)),
        exact_jacobians=True)


def _rel_odom(poses):
    """Odometry deltas of a pose track (``(..., T1, 3)``), the yaw
    wrapped."""
    import torch

    from tpuslam_torch.core import wrap_angle

    rel = poses[..., 1:, :] - poses[..., :-1, :]
    return torch.cat([rel[..., :2], wrap_angle(rel[..., 2:3])], dim=-1)


def _pos_rmse(poses, truth) -> float:
    return float(((poses[:, :2] - truth[:, :2]) ** 2).sum(-1).mean().sqrt())


def _large_system(cfg, poses, obs, edges, band: int, rel_odom, odom_info):
    """The reuse path's pieces (``slam/large.py``'s own): the constant H
    (frozen Omega, exact Jacobians, the odometry chain) and ``rhs(poses)``,
    one GN iteration's rhs rebuild."""
    from tpuslam_torch.slam import large

    t1 = poses.shape[0]
    scatter = large.build_banded_scatter(edges, t1, band)
    om, rel_obs, mask = large.exact_edge_terms(cfg, obs, edges, poses)
    h_flat, _ = large._constant_h(cfg, poses, om, mask, edges, t1, band,
                                  rel_odom, odom_info, 0.0, scatter)

    def rhs(p):
        return large._rhs(p, om, rel_obs, edges, t1, rel_odom, odom_info,
                          scatter)

    return h_flat, rhs


def _large_cost(cfg, poses, poses_init, obs, edges, rel_odom) -> float:
    """The GN objective the reuse path minimises: the edges' squared
    residuals weighted by Omega frozen at ``poses_init``, plus the
    odometry chain's (float64 sums)."""
    import torch

    from tpuslam_torch.core import wrap_angle
    from tpuslam_torch.slam.large import exact_edge_terms

    om, rel_obs, _ = exact_edge_terms(cfg, obs, edges, poses_init)
    rel = poses[edges.t_a] - poses[edges.t_b]
    err = torch.stack([rel[:, 0] - rel_obs[:, 0], rel[:, 1] - rel_obs[:, 1],
                       wrap_angle(wrap_angle(rel[:, 2]) - rel_obs[:, 2])],
                      dim=-1).double()
    odo = poses[1:] - poses[:-1] - rel_odom
    odo = torch.cat([odo[:, :2], wrap_angle(odo[:, 2:3])], dim=1).double()
    info = torch.tensor(LARGE_ODOM_INFO, dtype=torch.float64,
                        device=poses.device)
    return float(torch.einsum("ei,eij,ej->", err, om.double(), err)
                 + (odo * odo * info).sum())


def _large_small(dev) -> dict:
    """32. TestLargeSceneEndToEnd's 200-pose scene from the port's
    ``make_large_scene`` on the card: the tridiag solver with factor
    reuse, one-shot, with ``refactor_every`` 1 and 3, and CG, in float32
    on the card against the same calls in float64 on the CPU (equal
    ``gn_iters``, poses within LARGE_SMALL_ATOL); then the staged solves
    against the one-shot ones on the card, bit for bit.  Returns the
    scene, its CPU float64 copy and its constant H and rhs, which phase
    36 reuses."""
    import torch

    import numpy as np

    from tpuslam_torch.slam import (EdgeList, GraphObservations,
                                    graph_solve_banded, make_large_scene,
                                    make_large_scene_with_noise,
                                    window_pairs)
    from tpuslam_torch.slam.tridiag import (band_to_tridiag,
                                            banded_factor_tridiag_flat,
                                            banded_resolve_tridiag_flat,
                                            banded_solve_tridiag_flat,
                                            block_thomas_factor,
                                            block_thomas_solve,
                                            block_thomas_substitute,
                                            jacobi_prescale, pad_band)

    n, lms, radius, noise, w = LARGE_SMALL
    info = (1 / noise ** 2,) * 3
    cfg = _large_cfg(n, lms, max_gn_iters=20)
    pt, po, obs = make_large_scene(cfg, _gen(dev, 11), n, lms,
                                   radius=radius, odom_noise=noise,
                                   device=dev)
    el = window_pairs(obs.valid, window=w)
    cpu = (po.double().cpu(),
           GraphObservations(*(t.double().cpu() for t in obs[:3]),
                             obs.valid.cpu()),
           EdgeList(*(t.cpu() for t in el)))
    tol = dict(delta_tol=LARGE_SMALL_TOL * n)
    runs = {
        "tridiag, factor reuse": dict(solver="tridiag", **tol),
        "tridiag, one-shot": dict(solver="tridiag",
                                  reuse_factorization=False, **tol),
        "refactor_every=1": dict(solver="tridiag", relinearize_omega=True,
                                 refactor_every=1, **tol),
        "refactor_every=3": dict(solver="tridiag", relinearize_omega=True,
                                 refactor_every=3, **tol),
        "cg": dict(solver="cg", cg_iters=LARGE_SMALL_CG, delta_tol=0.0),
    }
    lines = []
    for name, kw in runs.items():
        c = (_large_cfg(n, lms, max_gn_iters=LARGE_SMALL_CG_GN)
             if name == "cg" else cfg)
        r32 = graph_solve_banded(c, po, obs, el, band=w,
                                 rel_odom=_rel_odom(po), odom_info=info,
                                 **kw)
        r64 = graph_solve_banded(c, *cpu, band=w,
                                 rel_odom=_rel_odom(cpu[0]), odom_info=info,
                                 **kw)
        gap = float((r32.poses.double().cpu() - r64.poses).abs().max())
        it32, it64 = int(r32.gn_iters), int(r64.gn_iters)
        _require(bool(r32.poses.isfinite().all()) and it32 == it64
                 and gap <= LARGE_SMALL_ATOL,
                 f"large {name}: gn_iters {it32}/{it64}, max|dpose| {gap}")
        cg32, cg64 = int(r32.cg_iters_last), int(r64.cg_iters_last)
        lines.append(f"{name} {it32} GN iterations (cg {cg32}/{cg64}), "
                     f"max|dpose| {gap:.3e}, "
                     f"rmse {_pos_rmse(r32.poses, pt):.4f} m")
    print(f"large parity, {n} poses / {lms} landmarks, window {w}, f32 on "
          f"the card against f64 on the CPU (atol {LARGE_SMALL_ATOL}; odometry"
          f" rmse {_pos_rmse(po, pt):.4f} m): " + "; ".join(lines), flush=True)

    # TestLargeSceneEndToEnd itself: the JAX package's scene (key 0),
    # rebuilt on the card from its draws, and the test's call.
    with np.load(LARGE_E2E_DRAWS) as f:
        draws = [torch.from_numpy(f[k]).to(dev) for k in
                 ("lm_offsets", "lm_perm", "scan_normals", "odom_normals")]
    e2e_pt, e2e_po, e2e_obs = make_large_scene_with_noise(
        cfg, n, lms, *draws, radius=radius, odom_noise=noise)
    res = graph_solve_banded(
        cfg, e2e_po, e2e_obs, window_pairs(e2e_obs.valid, window=w), band=w,
        rel_odom=_rel_odom(e2e_po), odom_info=info)
    rmse = _pos_rmse(res.poses, e2e_pt)
    rmse_odo = _pos_rmse(e2e_po, e2e_pt)
    _require(rmse < LARGE_RMSE_RATIO * rmse_odo,
             f"large end to end: rmse {rmse} against odometry's {rmse_odo}")
    print(f"large end to end (TestLargeSceneEndToEnd's scene and call, CG): "
          f"{int(res.gn_iters)} GN iterations, rmse {rmse:.4f} m against "
          f"odometry's {rmse_odo:.4f} m (ratio {rmse / rmse_odo:.4f}, below "
          f"{LARGE_RMSE_RATIO})", flush=True)

    # The staged solves equal the one-shot ones bit for bit on the card.
    h_flat, rhs = _large_system(cfg, po, obs, el, w, _rel_odom(po), info)
    b_flat = -rhs(po)
    fac = banded_factor_tridiag_flat(h_flat, w, w)
    flat_equal = torch.equal(banded_resolve_tridiag_flat(fac, b_flat, w),
                             banded_solve_tridiag_flat(h_flat, b_flat, w))
    h_band = h_flat.reshape(w + 1, 9, n).transpose(1, 2).reshape(
        w + 1, n, 3, 3)
    h_band, b_pad = pad_band(h_band, b_flat.T, w)
    diag, upper = band_to_tridiag(jacobi_prescale(h_band, b_pad)[0], w)
    gen = _gen(dev, 12)
    rows = torch.randn((diag.shape[0], diag.shape[1]), generator=gen,
                       device=dev)
    rows4 = torch.randn((diag.shape[0], 4, diag.shape[1]), generator=gen,
                        device=dev)
    thomas = block_thomas_factor(diag, upper)
    thomas_equal = all(
        torch.equal(block_thomas_substitute(thomas, b),
                    block_thomas_solve(diag, upper, b)) for b in (rows, rows4))
    _require(flat_equal and thomas_equal,
             f"large staged solves: flat {flat_equal}, Thomas {thomas_equal}")
    print(f"large staged solves on the card, {diag.shape[0]} super-blocks of "
          f"{diag.shape[1]}: factor then resolve equals the one-shot flat "
          f"solve, factor then substitute equals block_thomas_solve (1 and 4 "
          f"right-hand sides), bit for bit", flush=True)
    return {"cfg": cfg, "pt": pt, "po": po, "obs": obs, "el": el,
            "cpu": cpu, "h_flat": h_flat, "b_flat": b_flat}


def _events_ms(call):
    """``(result, host ms until the call returns, device ms, host syncs)``
    of one call: CUDA events around it, the host clock until it returns,
    and the synchronisations made inside it (``utils.count_host_syncs``;
    none is added around it)."""
    import torch

    from tpuslam_torch.utils import count_host_syncs

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with count_host_syncs() as syncs:
        t0 = time.perf_counter()
        out = call()
        host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return out, host_ms, start.elapsed_time(end), syncs.count


@contextlib.contextmanager
def _plain_chain():
    """The Thomas factor on its plain twin, the torch chain, in K6's
    place: ``tridiag.block_thomas_factor``, which every chain of the
    solvers reaches, is ``block_thomas_factor_plain`` meanwhile (the
    plain chain before K6, and the float64 references on the card, which
    K6 refuses)."""
    from tpuslam_torch.slam import tridiag

    factor = tridiag.block_thomas_factor
    tridiag.block_thomas_factor = tridiag.block_thomas_factor_plain
    try:
        yield
    finally:
        tridiag.block_thomas_factor = factor


def _device_ms(fn, reps: int) -> float:
    """Device milliseconds a call of ``fn`` (CUDA events around ``reps``
    calls after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _large_run(dev, smi, n, lms, chunk, radius_frac, main: bool) -> dict:
    """33-34. One of bench_graph_large's sizes: the scene and the host
    edge build timed apart, then the solve: one warm-up and LARGE_REPS
    timed calls at 10k (the main path: the device edge build checked
    against the host's, every repeat bit-equal to the warm-up, one GN
    iteration and the factor profiled), one at the scale-ups; host syncs
    of a timed call; then the factor and one GN iteration (rhs rebuild
    and substitution) timed apart, with the host clock a chain step.
    Returns the scene, its constant H and rhs, and the Thomas path's
    result and times, which phases 35-38 reuse."""
    import torch

    from tpuslam_torch.core import wrap_angle
    from tpuslam_torch.slam import (GraphObservations, count_window_pairs,
                                    graph_solve_banded, make_large_scene,
                                    window_pairs, window_pairs_device)
    from tpuslam_torch.slam.tridiag import (banded_factor_tridiag_flat,
                                            banded_resolve_tridiag_flat)

    w = LARGE_WINDOW
    label = f"large {n} poses / {lms} landmarks"
    cfg = _large_cfg(n, lms)
    (pt, po, obs), _, scene_ms, _ = _events_ms(lambda: make_large_scene(
        cfg, _gen(dev, 0), n, lms, radius=radius_frac * n,
        odom_noise=LARGE_ODOM_NOISE, scan_chunk=chunk, device=dev))
    el, _, edges_ms, _ = _events_ms(lambda: window_pairs(obs.valid, window=w))
    n_edges = el.t_b.shape[0]
    dev_line = ""
    if main:
        n_exact = count_window_pairs(obs.valid, w)
        (el_d, count), _, dev_ms, _ = _events_ms(
            lambda: window_pairs_device(obs.valid, w, n_exact))

        def keys(e):
            k = (e.t_b * n + e.t_a) * lms + e.lm
            return torch.where(e.valid, k, -1).sort().values

        same = (int(count) == n_exact == n_edges
                and torch.equal(keys(el_d), keys(el)))
        _require(same, f"{label}: the device edge build differs from the "
                 f"host's ({int(count)}, {n_exact}, {n_edges})")
        dev_line = (f", device build {dev_ms:.3f} ms (the same edge set, "
                    f"count {int(count)})")
    print(f"{label}: scene {scene_ms:.3f} ms, host edge build "
          f"{edges_ms:.3f} ms ({n_edges} edges){dev_line}; on {smi}",
          flush=True)

    rel = _rel_odom(po)

    def solve():
        return graph_solve_banded(
            cfg, po, obs, el, band=w, rel_odom=rel, odom_info=LARGE_ODOM_INFO,
            solver="tridiag", stall_ratio=LARGE_STALL,
            delta_tol=LARGE_TOL_PER_POSE * n)

    first = solve()
    times, syncs = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(LARGE_REPS if main else 1):
        res, _, ms, n_syncs = _events_ms(solve)
        times.append(ms)
        syncs.append(n_syncs)
        _require(torch.equal(res.poses, first.poses)
                 and int(res.gn_iters) == int(first.gn_iters),
                 f"{label}: a repeat solve changed the poses")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    iters = int(res.gn_iters)
    rmse, rmse_odo = _pos_rmse(res.poses, pt), _pos_rmse(po, pt)
    _require(bool(res.poses.isfinite().all()), f"{label}: non-finite poses")
    _require(max(syncs) <= iters + 2,
             f"{label}: {syncs} host syncs for {iters} GN iterations")
    cost0 = _large_cost(cfg, po, po, obs, el, rel)
    cost = _large_cost(cfg, res.poses, po, obs, el, rel)
    _require(cost < cost0, f"{label}: GN objective {cost} from {cost0}")
    f64_line = ""
    if main:
        # The same solve in float64 on the card, on the plain chain.
        obs64 = GraphObservations(*(t.double() for t in obs[:3]), obs.valid)
        with _plain_chain():
            res64 = graph_solve_banded(
                cfg, po.double(), obs64, el, band=w,
                rel_odom=_rel_odom(po.double()), odom_info=LARGE_ODOM_INFO,
                solver="tridiag", stall_ratio=LARGE_STALL,
                delta_tol=LARGE_TOL_PER_POSE * n)
        gap = res.poses.double() - res64.poses
        gap_xy = float(gap[:, :2].abs().max())
        gap_yaw = float(wrap_angle(gap[:, 2]).abs().max())
        _require(gap_xy <= LARGE_F64_ATOL[0] and gap_yaw <= LARGE_F64_ATOL[1],
                 f"{label}: f32 against f64 {gap_xy} m, {gap_yaw} rad")
        f64_line = (f"; against f64 on the card ({int(res64.gn_iters)} GN "
                    f"iterations): max|dxy| {gap_xy:.3e} m, max|dyaw| "
                    f"{gap_yaw:.3e} rad")
    ms = sorted(times)[len(times) // 2]
    with _plain_chain():
        plain, _, plain_ms, _ = _events_ms(solve)
    plain_gap = float((plain.poses - res.poses)[:, :2].abs().max())
    _require(bool(plain.poses.isfinite().all()),
             f"{label}: non-finite poses with the plain chain")
    print(f"{label}: solve with the plain chain in K6's place (before K6) "
          f"{plain_ms:.3f} ms, {int(plain.gn_iters)} GN iterations (K6's "
          f"{iters}), max|dxy| to K6's poses {plain_gap:.3e} m; on {smi}",
          flush=True)
    print(f"{label}: solve {ms:.3f} ms (median of {len(times)}: "
          f"{', '.join(f'{t:.3f}' for t in times)}), {iters} GN iterations, "
          f"delta_sum {float(res.delta_sum):.4e}, host syncs {syncs}, "
          f"repeats bit-equal, rmse {rmse:.4f} m against odometry's "
          f"{rmse_odo:.4f} m (ratio {rmse / rmse_odo:.4f}), objective "
          f"{cost:.6e} from the odometry's {cost0:.6e}, peak memory "
          f"{peak_gib:.2f} GiB{f64_line}; on {smi}", flush=True)

    # The factor and one GN iteration of the reuse path, apart.
    steps = -(-n // w)
    h_flat, rhs = _large_system(cfg, po, obs, el, w, rel, LARGE_ODOM_INFO)
    fac, f_host, f_ms, f_syncs = _events_ms(
        lambda: banded_factor_tridiag_flat(h_flat, w, w))
    with _plain_chain():
        _, _, f_plain_ms, _ = _events_ms(
            lambda: banded_factor_tridiag_flat(h_flat, w, w))

    def iteration():
        return banded_resolve_tridiag_flat(fac, -rhs(po), w)

    _, s_host, s_ms, s_syncs = _events_ms(iteration)
    _require(f_syncs == 0 and s_syncs == 0,
             f"{label}: the chain synchronised ({f_syncs}, {s_syncs})")
    m = 3 * w
    bound_ms, bound_by = _bound(steps * 3 * m * m * 4,
                                steps * THOMAS_OPS_PER_M3 * m ** 3)
    print(f"{label}: Thomas factor {f_ms:.3f} ms (the plain chain's "
          f"{f_plain_ms:.3f} ms; {steps} super-blocks of "
          f"{m}: {1e3 * f_ms / steps:.2f} us of device and "
          f"{1e3 * f_host / steps:.2f} us of host a step; bound "
          f"{bound_ms:.4f} ms, {bound_by}, for work in parallel that the "
          f"sequential chain does not have), one GN iteration "
          f"(rhs rebuild + substitution) {s_ms:.3f} ms "
          f"({1e3 * s_ms / steps:.2f} us of device and "
          f"{1e3 * s_host / steps:.2f} us of host a super-block, two "
          f"passes); no host sync in either; on {smi}",
          flush=True)
    if main:
        _profile(f"{label} Thomas factor",
                 lambda: banded_factor_tridiag_flat(h_flat, w, w), top_n=6)
        _profile(f"{label} one GN iteration", iteration, top_n=6)
    return {"n": n, "label": label, "cfg": cfg, "pt": pt, "po": po,
            "obs": obs, "el": el, "rel": rel, "h_flat": h_flat,
            "b_flat": -rhs(po), "iters": iters, "poses": res.poses,
            "solve_ms": ms, "cost0": cost0, "factor_ms": f_ms,
            "iteration_ms": s_ms}


def _large_cg(dev, system) -> None:
    """35. One ``cg_solve_flat`` on phase 33's 10k system: its iterations,
    time and host syncs (at most ceil(iters / CHECK_EVERY) + 2)."""
    from tpuslam_torch.core.pcg import CHECK_EVERY
    from tpuslam_torch.slam.large import cg_solve_flat

    (x, iters), _, ms, syncs = _events_ms(lambda: cg_solve_flat(
        system["h_flat"], system["b_flat"], LARGE_WINDOW))
    iters = int(iters)
    bound = -(-iters // CHECK_EVERY) + 2
    _require(bool(x.isfinite().all()), "large cg: non-finite solution")
    _require(syncs <= bound,
             f"large cg: {syncs} host syncs for {iters} iterations")
    print(f"large cg_solve_flat at {LARGE_SIZES[0][0]} poses: {iters} "
          f"iterations in {ms:.3f} ms, {syncs} host syncs (at most "
          f"{bound}: one read every {CHECK_EVERY} iterations)", flush=True)


def _solvers_small(dev, small) -> None:
    """36. The other banded solvers on phase 32's 200-pose scene: the GN
    with ``solver="cr"``, with ``solver="cholesky"`` and on the reuse path
    with each of LARGE_SMALL_PARTS, float32 on the card against float64
    on the CPU (equal ``gn_iters``, poses within LARGE_SMALL_ATOL);
    ``block_cr_solve`` against ``block_thomas_solve`` on a random SPD
    block-tridiagonal system; the partitioned factor and substitution
    against the sequential ones in float64 on the card."""
    import torch

    from tpuslam_torch.slam import block_cr_solve, graph_solve_banded
    from tpuslam_torch.slam.tridiag import (
        banded_factor_tridiag_flat, banded_resolve_tridiag_flat,
        block_thomas_factor_partitioned, block_thomas_solve,
        block_thomas_substitute_partitioned)

    n, lms, radius, noise, w = LARGE_SMALL
    info = (1 / noise ** 2,) * 3
    cfg, po, obs, el, cpu = (small[k] for k in
                             ("cfg", "po", "obs", "el", "cpu"))
    tol = dict(delta_tol=LARGE_SMALL_TOL * n)
    runs = {"cr": dict(solver="cr"), "cholesky": dict(solver="cholesky")}
    for c in LARGE_SMALL_PARTS:
        runs[f"tridiag n_parts={c}"] = dict(solver="tridiag", n_parts=c)
    lines = []
    for name, kw in runs.items():
        r32, host_ms, ms, _ = _events_ms(lambda: graph_solve_banded(
            cfg, po, obs, el, band=w, rel_odom=_rel_odom(po), odom_info=info,
            **kw, **tol))
        r64 = graph_solve_banded(cfg, *cpu, band=w,
                                 rel_odom=_rel_odom(cpu[0]), odom_info=info,
                                 **kw, **tol)
        gap = float((r32.poses.double().cpu() - r64.poses).abs().max())
        it32, it64 = int(r32.gn_iters), int(r64.gn_iters)
        _require(bool(r32.poses.isfinite().all()) and it32 == it64
                 and gap <= LARGE_SMALL_ATOL,
                 f"large {name}: gn_iters {it32}/{it64}, max|dpose| {gap}")
        lines.append(f"{name} {it32} GN iterations, max|dpose| {gap:.3e}, "
                     f"{ms:.3f} ms ({host_ms:.3f} ms of host)")
    print(f"banded solvers at {n} poses / {lms} landmarks, window {w}, f32 on "
          f"the card against f64 on the CPU (atol {LARGE_SMALL_ATOL}): "
          + "; ".join(lines), flush=True)

    # CR against Thomas on 256 random SPD blocks of 3 x 40 (10k poses'
    # super-block count after CR's padding), float32: the JAX test's
    # system of 6 x 6 blocks, its noise scaled by sqrt(6 / m) to keep the
    # same spectra.
    gen = _gen(dev, 13)
    nb, m = 256, 3 * LARGE_WINDOW
    scale = math.sqrt(6 / m)
    q = 0.1 * scale * torch.randn((nb, m, m), generator=gen, device=dev)
    diag = 4.0 * torch.eye(m, device=dev) + q + q.mT
    upper = 0.2 * scale * torch.randn((nb - 1, m, m), generator=gen,
                                      device=dev)
    rows = torch.randn((nb, m), generator=gen, device=dev)
    cr_gap = float((block_cr_solve(diag, upper, rows)
                    - block_thomas_solve(diag, upper, rows)).abs().max())
    _require(cr_gap <= LARGE_CR_BLOCK_ATOL,
             f"block_cr_solve against block_thomas_solve: {cr_gap}")

    # The partitioned factor against the sequential one, float64: on 24
    # random blocks of 3 x 40 in 2, 4 and 12 chunks, and on the scene's
    # flat system with each of LARGE_SMALL_PARTS.
    # Float64 chains on the card run the plain chain.
    d64, u64, rows64 = (t[:24].double() for t in (diag, upper, rows))
    u64 = u64[:23]
    part_gap = 0.0
    h64, b64 = small["h_flat"].double(), small["b_flat"].double()
    with _plain_chain():
        x_seq = block_thomas_solve(d64, u64, rows64)
        for c in (2, 4, 12):
            x = block_thomas_substitute_partitioned(
                block_thomas_factor_partitioned(d64, u64, c), rows64)
            part_gap = max(part_gap, float((x - x_seq).abs().max())
                           / float(x_seq.abs().max()))
        x_seq = banded_resolve_tridiag_flat(
            banded_factor_tridiag_flat(h64, w, w), b64, w)
        for c in LARGE_SMALL_PARTS:
            x = banded_resolve_tridiag_flat(
                banded_factor_tridiag_flat(h64, w, w, n_parts=c), b64, w)
            part_gap = max(part_gap, float((x - x_seq).abs().max())
                           / float(x_seq.abs().max()))
    _require(part_gap <= LARGE_PART_RTOL,
             f"the partitioned solves part from the sequential: {part_gap}")
    print(f"block_cr_solve against block_thomas_solve, {nb} blocks of {m}, "
          f"f32 on the card: max|dx| {cr_gap:.3e} (atol "
          f"{LARGE_CR_BLOCK_ATOL}); the partitioned factor and substitution "
          f"against the sequential ones, f64 on the card (24 blocks of {m} in "
          f"2, 4 and 12 chunks; phase 32's flat system in "
          f"{', '.join(map(str, LARGE_SMALL_PARTS))}): max|dx| "
          f"{part_gap:.3e} of the largest (at most {LARGE_PART_RTOL})",
          flush=True)


def _cho_solve_forms(dev, nb: int) -> None:
    """A CR level's solve at level 0's shapes (``nb`` odd blocks of 3 x
    40, 2 m + 1 right-hand sides): ``torch.cholesky_solve`` against the
    two batched ``solve_triangular`` calls that ``slam/cyclic.py`` makes,
    each profiled once (device ms, kernel launches) after a warm-up;
    their results agree."""
    import torch

    from tpuslam_torch.slam.cyclic import _cho_solve
    from tpuslam_torch.slam.tridiag import cholesky_nan
    from tpuslam_torch.utils import profile_window

    m = 3 * LARGE_WINDOW
    gen = _gen(dev, 14)
    q = torch.randn((nb, m, m), generator=gen, device=dev)
    chol = cholesky_nan(q @ q.mT + m * torch.eye(m, device=dev))
    y = torch.randn((nb, m, 2 * m + 1), generator=gen, device=dev)
    out = {}
    forms = {"torch.cholesky_solve": lambda: torch.cholesky_solve(y, chol),
             "two solve_triangular": lambda: _cho_solve(chol, y)}
    parts = []
    for name, fn in forms.items():
        out[name] = fn()
        got = profile_window(fn)
        parts.append(f"{name} {got['busy_ms']:.3f} ms of device, "
                     f"{got['launches']} kernel launches")
    gap = float((out["torch.cholesky_solve"]
                 - out["two solve_triangular"]).abs().max())
    _require(gap <= 1e-3 * float(out["torch.cholesky_solve"].abs().max()),
             f"the two SPD solves part: {gap}")
    print(f"CR level 0's solve at {nb} x {m} x {2 * m + 1}: "
          + "; ".join(parts) + f"; max|dx| {gap:.3e}", flush=True)


def _solvers_large(dev, smi, system: dict, main: bool) -> None:
    """37. Cyclic reduction and the partitioned factor on phases 33-34's
    constant H and rhs at one of bench_graph_large's sizes: the CR
    one-shot solve against the Thomas one-shot solve (a warm-up and
    LARGE_REPS timed calls at 10k, the repeats bit-equal, its gap to
    float64 held, one solve profiled; one call above), the partitioned
    factor and resolve at each of LARGE_PARTS, and the GN with
    ``solver="cr"`` and on the reuse path with the best of LARGE_PARTS,
    each held to the Thomas path's poses, syncs and objective."""
    import torch

    from tpuslam_torch.core import wrap_angle
    from tpuslam_torch.slam import graph_solve_banded
    from tpuslam_torch.slam.cyclic import (_pick_super_size,
                                           banded_solve_cr_flat)
    from tpuslam_torch.slam.tridiag import (banded_factor_tridiag_flat,
                                            banded_resolve_tridiag_flat,
                                            banded_solve_tridiag_flat)

    w, n, label = LARGE_WINDOW, system["n"], system["label"]
    h_flat, b_flat = system["h_flat"], system["b_flat"]
    ss = _pick_super_size(w, n)
    n_sup = -(-n // ss)
    n_pad = 1 << max(n_sup - 1, 0).bit_length()
    levels = n_pad.bit_length() - 1

    x_th, th_host, th_ms, _ = _events_ms(
        lambda: banded_solve_tridiag_flat(h_flat, b_flat, w))
    if main:
        first = banded_solve_cr_flat(h_flat, b_flat, w)
    times = []
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(LARGE_REPS if main else 1):
        x_cr, cr_host, ms, syncs = _events_ms(
            lambda: banded_solve_cr_flat(h_flat, b_flat, w))
        times.append(ms)
        _require(syncs == 0, f"{label}: CR synchronised {syncs} times")
        _require(not main or torch.equal(x_cr, first),
                 f"{label}: a repeat CR solve changed its solution")
    peak = torch.cuda.max_memory_allocated(dev)
    _require(bool(x_cr.isfinite().all()), f"{label}: non-finite CR solution")
    gap = float((x_cr - x_th).abs().max())
    ms = sorted(times)[len(times) // 2]
    bound_ms, bound_by = _bound(
        n_pad * 3 * (3 * ss) ** 2 * 4,
        n_pad * CR_OPS_PER_M3 * (3 * ss) ** 3)
    f64_line = ""
    if main:
        x64 = banded_solve_cr_flat(h_flat.double(), b_flat.double(), w)
        d = x_cr.double() - x64
        gap_xy, gap_yaw = (float(d[:, :2].abs().max()),
                           float(d[:, 2].abs().max()))
        _require(gap_xy <= LARGE_F64_ATOL[0] and gap_yaw <= LARGE_F64_ATOL[1],
                 f"{label}: CR f32 against f64 {gap_xy} m, {gap_yaw} rad")
        f64_line = (f"; against its f64 solve max|dxy| {gap_xy:.3e} m, "
                    f"max|dyaw| {gap_yaw:.3e} rad; repeats bit-equal")
    print(f"{label}: CR one-shot {ms:.3f} ms (median of {len(times)}: "
          f"{', '.join(f'{t:.3f}' for t in times)}; {cr_host:.3f} ms of host; "
          f"S {ss}, {n_sup} super-blocks padded to {n_pad}, {levels} levels; "
          f"peak {peak / 2 ** 30:.2f} GiB, {(peak - base) / 2 ** 30:.2f} above "
          f"the {base / 2 ** 30:.2f} held before; bound {bound_ms:.4f} ms, "
          f"{bound_by}) against the Thomas one-shot {th_ms:.3f} ms "
          f"({th_host:.3f} ms of host); max|x_cr - x_thomas| {gap:.3e}"
          f"{f64_line}; on {smi}", flush=True)
    if main:
        _profile(f"{label} CR one-shot",
                 lambda: banded_solve_cr_flat(h_flat, b_flat, w), top_n=6,
                 levels=levels)
        _cho_solve_forms(dev, n_pad // 2)

    # The partitioned factor and one resolve at each chunk count.
    best, parts = None, []
    iters = system["iters"]
    for c in LARGE_PARTS:
        fac, f_host, f_ms, f_syncs = _events_ms(
            lambda: banded_factor_tridiag_flat(h_flat, w, w, n_parts=c))
        x, r_host, r_ms, r_syncs = _events_ms(
            lambda: banded_resolve_tridiag_flat(fac, b_flat, w))
        m = fac.factor.chunk.invs.shape[0] + 1
        del fac
        steps = (m - 1) + 2 * max(m - 2, 0) + c
        p_gap = float((x - x_th).abs().max())
        _require(bool(x.isfinite().all()) and f_syncs == 0 and r_syncs == 0,
                 f"{label}: partitioned C={c}: finite {bool(x.isfinite().all())}"
                 f", syncs {f_syncs}, {r_syncs}")
        total = f_ms + iters * r_ms
        if best is None or total < best[1]:
            best = (c, total)
        parts.append(f"C={c} ({m} super-blocks a chunk): factor {f_ms:.3f} ms "
                     f"({1e3 * f_host / steps:.2f} us of host a chain step, "
                     f"{steps} steps), resolve {r_ms:.3f} ms "
                     f"({1e3 * r_host / (2 * (m - 1) + c):.2f} us of host a "
                     f"step), max|x - x_thomas| {p_gap:.3e}")
    print(f"{label}: partitioned Thomas (the sequential factor "
          f"{system['factor_ms']:.3f} ms, a GN iteration "
          f"{system['iteration_ms']:.3f} ms): " + "; ".join(parts)
          + f"; on {smi}", flush=True)

    # The GN with CR and on the reuse path with the best chunk count.
    cfg, po, obs, el, rel = (system[k] for k in
                             ("cfg", "po", "obs", "el", "rel"))
    lines = []
    for name, kw in (("cr", dict(solver="cr")),
                     (f"tridiag n_parts={best[0]}",
                      dict(solver="tridiag", n_parts=best[0]))):
        res, _, g_ms, g_syncs = _events_ms(lambda: graph_solve_banded(
            cfg, po, obs, el, band=w, rel_odom=rel, odom_info=LARGE_ODOM_INFO,
            stall_ratio=LARGE_STALL, delta_tol=LARGE_TOL_PER_POSE * n, **kw))
        g_iters = int(res.gn_iters)
        d = res.poses - system["poses"]
        g_gap = max(float(d[:, :2].abs().max()),
                    float(wrap_angle(d[:, 2]).abs().max()))
        cost = _large_cost(cfg, res.poses, po, obs, el, rel)
        _require(bool(res.poses.isfinite().all()) and g_syncs <= g_iters + 2
                 and g_gap <= LARGE_CROSS_ATOL and cost < system["cost0"],
                 f"{label} GN {name}: {g_iters} iterations, {g_syncs} syncs, "
                 f"max|dpose| {g_gap} from Thomas's, objective {cost} from "
                 f"{system['cost0']}")
        lines.append(f"{name} {g_ms:.3f} ms, {g_iters} GN iterations, "
                     f"{g_syncs} host syncs, max|dpose| {g_gap:.3e} from "
                     f"Thomas's, objective {cost:.6e}")
    print(f"{label}: GN (Thomas with factor reuse {system['solve_ms']:.3f} ms,"
          f" {iters} GN iterations; objective from {system['cost0']:.6e}): "
          + "; ".join(lines) + f"; on {smi}", flush=True)


def _cholesky_large(dev, smi, system: dict) -> None:
    """38. One ``banded_solve_direct_flat`` on phase 33's 10k system: its
    time, the host's time a row, its host syncs (none) and its gap to the
    Thomas solution."""
    from tpuslam_torch.slam.cholesky import banded_solve_direct_flat
    from tpuslam_torch.slam.tridiag import banded_solve_tridiag_flat

    w, n, label = LARGE_WINDOW, system["n"], system["label"]
    h_flat, b_flat = system["h_flat"], system["b_flat"]
    x_th = banded_solve_tridiag_flat(h_flat, b_flat, w)
    x, host_ms, ms, syncs = _events_ms(
        lambda: banded_solve_direct_flat(h_flat, b_flat, w))
    gap = float((x - x_th).abs().max())
    _require(bool(x.isfinite().all()) and syncs == 0,
             f"{label}: banded Cholesky finite {bool(x.isfinite().all())}, "
             f"{syncs} syncs")
    print(f"{label}: banded Cholesky {ms:.3f} ms ({1e3 * host_ms / n:.2f} us "
          f"of host a row, {n} rows, two passes), no host sync, "
          f"max|x - x_thomas| {gap:.3e}; on {smi}", flush=True)


def _thomas_kernel(dev, smi) -> dict:
    """39. K6 on the graph_large cell: THOMAS_SCENES seeded scenes at
    LARGE_SIZES[0] solved as the cell solves them (one lockstep
    ``graph_solve_banded``, the factor-reuse path), twice, with the
    launches counted from zero: the first call captures the factor's CUDA
    graph, the second replays it, profiled (K6 its factor's device work,
    no library Cholesky, one launch for its one factor span, its poses
    the first call's).  Then the same chain, prescaled and densified as
    the solve does it: two launches bit-equal, K6 and the plain chain held
    to the chain in float64; K6's time a launch and a step beside its
    bound, the plain chain's (eager, and as the CUDA graph the cell
    replayed before K6: ``library_ms``), and K6 on one scene (eight CTAs a
    matrix).  Returns its ``kernels`` entry."""
    import torch

    from tpuslam_torch.ops import _build, thomas_cuda
    from tpuslam_torch.slam import (EdgeList, GraphObservations,
                                    graph_solve_banded, make_large_scene,
                                    window_pairs_device)
    from tpuslam_torch.slam.tridiag import (_flat_prescale, _flat_to_tridiag,
                                            block_thomas_factor_plain,
                                            pad_flat)
    from tpuslam_torch.utils import profile_window

    n, lms, _, radius_frac = LARGE_SIZES[0]
    w = LARGE_WINDOW
    cfg = _large_cfg(n, lms)
    poses, obs, edges, systems = [], [], [], []
    for s in range(THOMAS_SCENES):
        _, po, ob = make_large_scene(
            cfg, _gen(dev, 100 + s), n, lms, radius=radius_frac * n,
            odom_noise=LARGE_ODOM_NOISE, device=dev)
        el, count = window_pairs_device(ob.valid, w, 8 * w * n)
        systems.append(_large_system(cfg, po, ob, el, w, _rel_odom(po),
                                     LARGE_ODOM_INFO)[0])
        poses.append(po)
        obs.append(ob)
        edges.append((el, int(count)))
    e = max(count for _, count in edges)
    edges = EdgeList(*(torch.stack([f[:e] for f in fields])
                       for fields in zip(*(el for el, _ in edges))))
    poses = torch.stack(poses)
    obs = GraphObservations(*(torch.stack(f) for f in zip(*obs)))
    rel = _rel_odom(poses)
    solved = {}

    def solve(key):
        solved[key] = graph_solve_banded(
            cfg, poses, obs, edges, band=w, rel_odom=rel,
            odom_info=LARGE_ODOM_INFO, solver="tridiag",
            stall_ratio=LARGE_STALL, delta_tol=LARGE_TOL_PER_POSE * n)

    _build.launches.clear()
    solve("capture")
    torch.cuda.synchronize()
    first = _build.launches["thomas_factor"]
    got = profile_window(lambda: solve("replay"))
    replayed = _build.launches["thomas_factor"] - first
    factors = got["spans"].get("tpuslam.graph_large.factor",
                               {}).get("count", 0)
    call = (f"the cell's solve ({THOMAS_SCENES} scenes of {n} poses in "
            f"lockstep, factor reuse)")
    # The first call runs the factor before its capture and replays it;
    # the capture itself runs nothing.
    _require(first == 2 and replayed == factors == 1,
             f"{call}: K6 launches {first} in the capturing call, "
             f"{replayed} in the replayed call for {factors} factor spans")
    kernels = [(name, ms) for name, ms in got["top"]
               if not name.startswith("aten::")]
    library = [k for k, _ in kernels if any(
        lib in k for lib in ("potrf", "batch_trsm", "offsetPointerArray"))]
    k6_ms = sum(ms for k, ms in kernels if "thomas_factor_kernel" in k)
    _require(not library and k6_ms > 0,
             f"{call}: the factor ran {kernels}")
    a, b = solved["capture"], solved["replay"]
    _require(torch.equal(a.poses, b.poses)
             and torch.equal(a.gn_iters, b.gn_iters),
             f"{call}: the replayed call's poses differ from the first's")
    launches = first + replayed
    print(f"{call}: replayed call {got['wall_ms']:.3f} ms, device busy "
          f"{got['busy_ms']:.3f} ms, of it K6 {k6_ms:.3f} ms; no potrf, "
          f"batch_trsm or offsetPointerArray kernel; K6 launches counted "
          f"from zero over the two calls {launches} (the capturing call 2: "
          f"the run before the capture and the replay; the replayed call "
          f"{replayed} for its {factors} factor span), GN iterations "
          f"{sorted(set(b.gn_iters.tolist()))}, poses equal the capturing "
          f"call's; on "
          f"{smi}", flush=True)
    del poses, obs, edges, rel, solved, a, b

    h = torch.stack(systems)
    del systems
    h_pad, b_pad = pad_flat(h, h.new_zeros((h.shape[0], 3, h.shape[-1])), w)
    h_s, _, _ = _flat_prescale(h_pad, b_pad, w)
    diag, upper = _flat_to_tridiag(h_s, w, w)
    del h, h_pad, h_s
    steps, batch, m = diag.shape[0], diag.shape[1], diag.shape[-1]
    resident = thomas_cuda._plan(dev, m)[2]
    cluster = thomas_cuda.cluster_size(batch, resident)
    label = (f"K6 at {steps} x {batch} x {m} ({cluster} CTAs a matrix; "
             f"resident clusters of 1-8 CTAs {resident})")
    k6 = thomas_cuda.thomas_factor(diag, upper)
    again = thomas_cuda.thomas_factor(diag, upper)
    _require(torch.equal(again[0], k6[0]) and torch.equal(again[1], k6[1]),
             f"{label}: two launches on equal inputs differ")
    ref = block_thomas_factor_plain(diag.double(), upper.double())
    plain = block_thomas_factor_plain(diag, upper)
    errs = {}
    for i, name in enumerate(("invs", "ws")):
        want = getattr(ref, name)
        scale = float(want.abs().max())
        e6 = float((k6[i].double() - want).abs().max()) / scale
        ep = float((getattr(plain, name).double() - want).abs().max()) / scale
        _require(e6 <= THOMAS_ERR_RATIO * ep + THOMAS_ERR_FLOOR,
                 f"{label}: {name} {e6:.3e} from float64, the plain chain's "
                 f"{ep:.3e}")
        errs[name] = (e6, ep)
    del ref, plain, again, k6

    ms = _device_ms(lambda: thomas_cuda.thomas_factor(diag, upper), 5)
    plain_ms = _device_ms(lambda: block_thomas_factor_plain(diag, upper), 2)
    # The plain chain as the CUDA graph the cell replayed before K6.
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        block_thomas_factor_plain(diag, upper)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        block_thomas_factor_plain(diag, upper)
    library_ms = _device_ms(graph.replay, 5)
    del graph
    one = (diag[:, 0].contiguous(), upper[:, 0].contiguous())
    one_ms = _device_ms(lambda: thomas_cuda.thomas_factor(*one), 5)
    bound_ms, bound_by = _bound(steps * batch * 16 * m * m,
                                steps * batch * THOMAS_OPS_PER_M3 * m ** 3)
    print(f"{label}: {ms:.3f} ms a launch ({1e3 * ms / steps:.2f} us a "
          f"step), bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * bound_ms / ms:.2f}% of it); the plain chain {plain_ms:.3f} "
          f"ms eager, {library_ms:.3f} ms as a CUDA graph ({library_ms / ms:.1f}"
          f" x K6); one scene {one_ms:.3f} ms ({1e3 * one_ms / steps:.2f} us "
          f"a step, {thomas_cuda.cluster_size(1, resident)} CTAs); against "
          f"float64: " + ", ".join(f"{k} {e6:.3e} (plain {ep:.3e})"
                                   for k, (e6, ep) in errs.items())
          + f"; two launches bit-equal; on {smi}", flush=True)
    return {"name": "thomas_factor", "route": "cuda",
            "source": "tpuslam_torch/csrc/thomas_factor.cu",
            "replaces": None, "launches": launches,
            "max_abs_err": max(e6 for e6, _ in errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _large_phases(dev, smi) -> list:
    """Large-scale graph SLAM's phases, in order; returns K6's
    ``kernels`` entry."""
    t0 = time.perf_counter()
    small = _large_small(dev)
    t_new = time.perf_counter()
    _solvers_small(dev, small)
    new_s = time.perf_counter() - t_new
    # Phase 37 runs on each size's scene and H right after phases 33-34
    # built them, so only the 10k scene is held while a larger one runs.
    for k, (n, lms, chunk, radius_frac) in enumerate(LARGE_SIZES):
        out = _large_run(dev, smi, n, lms, chunk, radius_frac, main=k == 0)
        t_new = time.perf_counter()
        _solvers_large(dev, smi, out, main=k == 0)
        new_s += time.perf_counter() - t_new
        if k == 0:
            system = out
        del out
    _large_cg(dev, system)
    t_new = time.perf_counter()
    _cholesky_large(dev, smi, system)
    new_s += time.perf_counter() - t_new
    del system
    t_k6 = time.perf_counter()
    entry = _thomas_kernel(dev, smi)
    print(f"large phases 32-39: {time.perf_counter() - t0:.1f} s, of which "
          f"the other banded solvers' phases 36-38 {new_s:.1f} s and K6's "
          f"phase 39 {time.perf_counter() - t_k6:.1f} s", flush=True)
    return [entry]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available")

    from tpuslam_torch import entry as entry_mod
    from tpuslam_torch.filters import EkfConfig
    from tpuslam_torch.ops import _build, ekf_cuda
    from tpuslam_torch.utils import kernel_report, timed

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = EkfConfig()

    # 1. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}"
          f" (CUDA {torch.version.cuda}), device {torch.cuda.get_device_name(dev)}")
    print(smi, flush=True)

    # 2. Build, then what the compiler and the occupancy calculator say of
    # each kernel (registers, stack frame, spills; the PF kernels' SASS
    # opcodes; resident blocks a SM).
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: nvcc {_build.build_seconds:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in kernel_report.report_lines(BATCH_MAIN[1]):
        print(line, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    k1_floors = _k1_floors(clock_mhz)

    # 3. Noise-free parity (the JAX package's on-chip gate: atol 1e-4 after
    # 50 steps, accumulator below 1e-6).  Phases 3 and 4 run each shape in
    # both of K1's forms (:func:`_k1_both_forms`), with NEES and without.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    large = ekf_cuda.LANES_BELOW_PER_SM * sms
    b, n = 1024, 50
    err_free, max_acc = 0.0, 0.0
    for nees in (False, True):
        gap, outs = _k1_both_forms(
            cfg, 0, b, n, dev, dict(atol_state=1e-4, rtol_cov=0.0,
                                    atol_cov=1e-4),
            noise_on=False, with_nees=nees)
        err_free = max(err_free, gap)
        max_acc = max(max_acc, *(float(out[1].abs().max()) for out in outs))
    _require(max_acc < 1e-6, f"noise-free accumulator {max_acc}")
    print(f"parity noise-free {b}x{n} (small-batch form) and {large}x{n} "
          f"(one-thread), NEES off and on: max|kernel-plain| "
          f"{err_free:.3e} (atol 1e-4), max|err| {max_acc:.3e} (< 1e-6); "
          f"the small-batch words equal the one-thread form's",
          flush=True)

    # 4. Noise on, same normals into both (tolerance from FMA contraction and
    # polynomial-sincos rounding: atol 1e-3 on poses, 1e-4 relative on cov),
    # then the Philox stream itself at the entry point's shape (one-thread
    # form) and at an odd step count: the last step's yaw normal is the
    # first of its own pair, whose second goes unused.
    tol = dict(atol_state=1e-3, rtol_cov=1e-4, atol_cov=1e-7)
    b, n = 4096, 64
    gen = torch.Generator(device=dev).manual_seed(2024)
    normals = torch.randn((n, 5, large), generator=gen, device=dev)
    b_odd, n_odd = ODD_SHAPE
    err_nrm, err_philox = 0.0, 0.0
    for nees in (False, True):
        err_nrm = max(err_nrm, _k1_both_forms(
            cfg, 0, b, n, dev, tol, with_nees=nees, normals=normals)[0])
        err_philox = max(err_philox, _k1_both_forms(
            cfg, 6, b_odd, n_odd, dev, tol, with_nees=nees)[0])
    b_e, n_e = entry_mod.BATCH, entry_mod.N_STEPS
    err_philox = max(err_philox, _compare(
        ekf_cuda.ekf_fused_rollout(cfg, 5, b_e, n_e, device=dev),
        ekf_cuda.ekf_fused_rollout_plain(cfg, 5, b_e, n_e, device=dev),
        **tol))
    torch.cuda.synchronize()
    print(f"parity noise-on, both forms, NEES off and on: injected normals "
          f"{b}x{n} and {large}x{n} max|kernel-plain| {err_nrm:.3e}; "
          f"Philox {b_odd}x{n_odd} and {large}x{n_odd} (odd steps), "
          f"{b_e}x{n_e} {err_philox:.3e} (atol 1e-3 poses, rtol 1e-4 cov); "
          f"the small-batch words equal the one-thread form's", flush=True)

    # 5. Philox noise bands.
    b, n = BASELINE
    final, err, nees = ekf_cuda.ekf_fused_rollout(cfg, 12345, b, n,
                                                  with_nees=True, device=dev)
    _require(final.x_hat.shape == (b, 3) and final.cov.shape == (b, 3, 3),
             f"shapes {final.x_hat.shape}, {final.cov.shape}")
    _require(bool(final.x_hat.isfinite().all() & final.cov.isfinite().all()),
             "non-finite final state")
    rmse = float(torch.sqrt(err / n).mean())
    mean_nees = float((nees / n).mean())
    _require(RMSE_BAND[0] < rmse < RMSE_BAND[1], f"RMSE {rmse} off-band")
    _require(NEES_BAND[0] < mean_nees < NEES_BAND[1],
             f"NEES {mean_nees} off-band")
    print(f"bands {b}x{n}: rmse {rmse:.4f} in {RMSE_BAND}, nees "
          f"{mean_nees:.4f} in {NEES_BAND}", flush=True)

    # 6. The main path through the user's entry point; only these launches
    # are counted.
    fn, args = entry_mod.entry(device="cuda")
    _build.launches.clear()
    value = float(fn(*args))
    torch.cuda.synchronize()
    launches = (_build.launches["ekf_rollout"]
                + _build.launches["ekf_rollout_lanes"])
    _require(launches >= 1, "the entry point did not launch the kernel")
    _require(math.isfinite(value) and 0.0 < value < 2.0,
             f"entry RMSE {value}")
    print(f"entry(device='cuda'): rmse {value:.4f}, kernel launches "
          f"{launches}", flush=True)

    # 7. Timing: CUDA events, median of reps after warm-up.  Every timed
    # call keeps its output; afterwards the kernel's output at each timed
    # shape is held to the plain version's on the same seed and Philox
    # stream, at the tolerances of phase 4.
    out = {}

    def rate(label, shape, fn, work, reps=5, warmup=1):
        def call():
            out[label] = fn()
        seconds = timed(call, reps=reps, warmup=warmup, device=dev)
        print(f"timing {label} {shape}: {work / seconds:.4e} steps/s "
              f"({seconds * 1e3:.3f} ms) on {smi}", flush=True)
        return seconds

    ms = {}
    for label, (b, n) in (("flagship", FLAGSHIP), ("baseline", BASELINE)):
        ms[label] = 1e3 * rate(
            label, f"kernel {b}x{n}",
            lambda b=b, n=n: ekf_cuda.ekf_fused_rollout(cfg, 1, b, n,
                                                        device=dev), b * n)
    if k1_floors is not None:
        print(f"K1 flagship {ms['flagship']:.3f} ms against its issue floor "
              f"{k1_floors['issue']:.3f} ms: "
              f"{100 * k1_floors['issue'] / ms['flagship']:.1f}% of the issue"
              " rate", flush=True)
    k, b, n = SWEEPS
    rate("sweeps", f"kernel {k}x{b}x{n}",
         lambda: ekf_cuda.ekf_fused_sweeps(cfg, 1, k, b, n, device=dev),
         k * b * n)
    b, n = BASELINE
    rate("plain baseline", f"{b}x{n}",
         lambda: ekf_cuda.ekf_fused_rollout_plain(cfg, 1, b, n, device=dev),
         b * n, reps=3)
    b, n = FLAGSHIP
    plain_ms = 1e3 * rate(
        "plain flagship", f"{b}x{n}",
        lambda: ekf_cuda.ekf_fused_rollout_plain(cfg, 1, b, n, device=dev),
        b * n, reps=1, warmup=0)

    tol = dict(atol_state=1e-3, rtol_cov=1e-4, atol_cov=1e-7)
    err_timed = {label: _compare(out[label], out.pop(f"plain {label}"),
                                 **tol)
                 for label in ("flagship", "baseline")}
    # The sweeps launch against the plain rollout of all k * b rollouts,
    # reduced to per-sweep RMSE the same way.
    k, b, n = SWEEPS
    s_final, s_rmse = out.pop("sweeps")
    p_final, p_err = ekf_cuda.ekf_fused_rollout_plain(cfg, 1, k * b, n,
                                                      device=dev)
    p_rmse = torch.sqrt(p_err.reshape(k, b).mean(dim=1) / n)
    _require(s_rmse.shape == (k,) and s_final.x_hat.shape == (k * b, 3),
             f"sweeps shapes {s_rmse.shape}, {s_final.x_hat.shape}")
    err_timed["sweeps"] = _compare((s_final, s_rmse), (p_final, p_rmse),
                                   **tol)
    print("parity at the timed shapes, seed 1: " + ", ".join(
        f"{label} max|kernel-plain| {e:.3e}" for label, e in
        err_timed.items()) + " (atol 1e-3 poses, rtol 1e-4 cov)",
        flush=True)

    pf_entries, default_fired = _pf_phases(dev, smi)
    pf_entries += _batch_phases(dev, smi)
    pf_entries += _merge_phases(dev, smi, default_fired)
    _graph_phases(dev, smi)
    pf_entries += _large_phases(dev, smi)

    b, n = FLAGSHIP
    bound_ms, bound_by = _bound(80 * b + 20 * n, EKF_OPS_PER_STEP * b * n,
                                EKF_INT_OPS_PER_STEP * b * n)
    print(json.dumps({"kernels": [{
        "name": "ekf_rollout",
        "route": "cuda",
        "source": "tpuslam_torch/csrc/ekf_rollout.cu",
        "replaces": "tpuslam/ops/ekf_pallas.py:59",
        "launches": launches,
        "max_abs_err": max(err_free, err_nrm, err_philox,
                           *err_timed.values()),
        "ms": ms["flagship"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, *pf_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
