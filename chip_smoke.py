#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched EKF path once on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``tpuslam_torch/csrc``, holds each kernel
against its plain torch version on the card, checks the noisy filter
against the reference's statistical bands, runs the package's entry
point, and times the kernel and the plain version at the main path's
shapes, holding the kernel's output there to the plain version's too.  Each phase prints one line; a failing phase raises, so the script
exits non-zero and prints no result.  The second-to-last line is a JSON
object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  It needs a CUDA device and imports no
JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Bench shapes of the main path: the flagship (rollouts x steps) and the
# latency-bound BASELINE config 3, plus the stacked-sweeps variant.
FLAGSHIP = (8_388_608, 1600)
BASELINE = (8192, 400)
SWEEPS = (64, 8192, 400)

# Bands of the noisy filter at 8192 x 400: per-rollout RMSE and NEES of the
# posterior position, as the JAX package's on-chip gate holds them.
RMSE_BAND = (0.25, 0.50)
NEES_BAND = (0.7, 2.5)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available")

    from tpuslam_torch import entry as entry_mod
    from tpuslam_torch.filters import EkfConfig
    from tpuslam_torch.ops import _build, ekf_cuda
    from tpuslam_torch.utils import timed

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

    # 2. Build.
    t0 = time.perf_counter()
    _build.load_library()
    regs = sorted({line.split("Used ")[1].split(" registers")[0]
                   for line in _build.build_log.splitlines()
                   if "registers" in line})
    print(f"build: nvcc {_build.build_seconds:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s, registers/thread "
          f"{'/'.join(regs) or 'cached'}", flush=True)

    # 3. Noise-free parity (the JAX package's on-chip gate: atol 1e-4 after
    # 50 steps, accumulator below 1e-6).
    before = ekf_cuda.launch_count
    b, n = 1024, 50
    kern = ekf_cuda.ekf_fused_rollout(cfg, 0, b, n, noise_on=False,
                                      device=dev)
    plain = ekf_cuda.ekf_fused_rollout_plain(cfg, 0, b, n, noise_on=False,
                                             device=dev)
    torch.cuda.synchronize()
    _require(ekf_cuda.launch_count == before + 1, "launch not counted")
    err_free = _compare(kern, plain, atol_state=1e-4, rtol_cov=0.0,
                        atol_cov=1e-4)
    _require(float(kern[1].abs().max()) < 1e-6, "noise-free accumulator")
    print(f"parity noise-free {b}x{n}: max|kernel-plain| {err_free:.3e} "
          "(atol 1e-4), max|err| "
          f"{float(kern[1].abs().max()):.3e} (< 1e-6)", flush=True)

    # 4. Noise on, same normals into both (tolerance from FMA contraction and
    # polynomial-sincos rounding: atol 1e-3 on poses, 1e-4 relative on cov),
    # then the Philox stream itself at the entry point's shape.
    b, n = 4096, 64
    gen = torch.Generator(device=dev).manual_seed(2024)
    normals = torch.randn((n, 5, b), generator=gen, device=dev)
    err_nrm = _compare(
        ekf_cuda.ekf_fused_rollout(cfg, 0, b, n, normals=normals,
                                   with_nees=True, device=dev),
        ekf_cuda.ekf_fused_rollout_plain(cfg, 0, b, n, normals=normals,
                                         with_nees=True, device=dev),
        atol_state=1e-3, rtol_cov=1e-4, atol_cov=1e-7)
    b, n = entry_mod.BATCH, entry_mod.N_STEPS
    err_philox = _compare(
        ekf_cuda.ekf_fused_rollout(cfg, 5, b, n, device=dev),
        ekf_cuda.ekf_fused_rollout_plain(cfg, 5, b, n, device=dev),
        atol_state=1e-3, rtol_cov=1e-4, atol_cov=1e-7)
    torch.cuda.synchronize()
    print(f"parity noise-on: injected normals 4096x64 max|kernel-plain| "
          f"{err_nrm:.3e}, Philox {b}x{n} {err_philox:.3e} (atol 1e-3 "
          "poses, rtol 1e-4 cov)", flush=True)

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
    ekf_cuda.launch_count = 0
    value = float(fn(*args))
    torch.cuda.synchronize()
    launches = ekf_cuda.launch_count
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
