"""Time K1, the segmented K3b and the PF kernels that share K1's device
math of several checkouts of the port on one card, in turns.

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
  BASELINE (8192 x 400; 20 calls queued behind a sleep kernel) shapes;
* K1's largest kernel-minus-plain difference with noise off (1024 x 50)
  and with injected normals (4096 x 64), ``chip_smoke.py``'s phase 3 and
  4 shapes, and a digest of the kernel's outputs there;
* the segmented K3b's device time a launch at 1024 x 10,000 with 0, 240
  and 1024 filters firing (20 launches behind a sleep kernel), and a
  digest of its valid rows;
* the device time a launch and a digest of the outputs of K2b at
  2,097,152 particles, K4 at 8192 x 1000 and K5b at 1024 x 10,000 (Philox
  noise, a mixed gate), which share ``csrc/fastmath.cuh`` with K1.

Equal digests mean equal outputs, bit for bit, across checkouts.  Needs
a CUDA device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

FLAGSHIP = (8_388_608, 1600)
BASELINE = (8192, 400)
K3B_SHAPE = (1024, 10_000)
K3B_FIRING = (0, 240, 1024)
K2_N = 2_097_152
K4_SHAPE = (8192, 1000)


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


def seg_args(dev, b: int, n: int, n_fire: int, seed: int = 16,
             one_survivor: bool = False):
    """The segmented K3b's arguments at ``b`` filters of ``n`` particles:
    a spread cloud, log weights whose spread grows with the filter,
    ``n_fire`` filters spread over the batch firing, their boundaries
    from K5a.  With ``one_survivor`` one particle a filter holds all the
    weight and takes every slot."""
    import torch

    from tpuslam_torch.ops import pf_batch_cuda as pb

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
    slots = pb.wide_slots(log_w, lse, fire, offs)
    t_hi = pb.wide_boundary(slots.cum, slots.fids, slots.valid,
                            slots.inv_tot, slots.offs)
    return particles, t_hi, slots.fids, slots.valid


def _pf_args(dev):
    """K2b's, K4's and K5b's arguments: spread clouds around x0, log
    weights whose spread grows with the filter (a mixed ESS gate), one
    noisy observation of the five landmarks a filter."""
    import torch

    from tpuslam_torch.core.se2 import world_to_robot
    from tpuslam_torch.filters import PfConfig
    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs

    f32 = dict(dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    x0 = torch.tensor(PfConfig().x0, **f32)
    lm = torch.tensor(PfConfig().landmarks, **f32)
    z_true = world_to_robot(x0, lm)
    spread = torch.tensor([0.5, 0.5, 0.2], **f32)

    p_rows = (x0[:, None] + spread[:, None]
              * torch.randn((3, K2_N), generator=g, **f32)).contiguous()
    lw = 2.0 * torch.randn(K2_N, generator=g, **f32)
    z = (z_true + 0.3 * torch.randn(z_true.shape, generator=g, **f32))
    k2 = (PfConfig(num_particles=K2_N, weight_mode="log",
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
        slots = pb.wide_slots(log_w, st.lse, fire,
                              torch.rand(b, generator=g, **f32))
        t_hi = pb.wide_boundary(slots.cum, slots.fids, slots.valid,
                                slots.inv_tot, slots.offs)
        expanded = rs.resample_expand_seg(parts, t_hi, slots.fids,
                                          slots.valid)
        out[name] = (cfg, 1, parts, log_w, zb, bad, fire, slots.src,
                     expanded)
    return k2, out["k4"], out["k5b"]


def _measure(tree: pathlib.Path) -> dict:
    """The measurements of the module docstring, for the package of
    ``tree``."""
    sys.path.insert(0, str(tree))
    import torch

    import tpuslam_torch
    from tpuslam_torch.filters import EkfConfig
    from tpuslam_torch.ops import _build, ekf_cuda, pf_cuda
    from tpuslam_torch.ops import pf_batch_cuda as pb
    from tpuslam_torch.ops import resample_cuda as rs
    from tpuslam_torch.utils import timed

    device_ms = _own_profiling().device_ms

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

    for n_fire in K3B_FIRING:
        args = seg_args(dev, *K3B_SHAPE, n_fire)
        out[f"k3b_{n_fire}_ms"] = device_ms(
            lambda: rs.resample_expand_seg(*args), 20)
        rows = rs.resample_expand_seg(*args)
        out[f"k3b_{n_fire}_digest"] = _digest(rows[:, args[3]])

    k2, k4, k5b = _pf_args(dev)
    for name, fn in (("k2b", lambda: pf_cuda.pf_step_rows(*k2)),
                     ("k4", lambda: pb.pf_batch_step_rows(*k4)),
                     ("k5b", lambda: pb.wide_stats_rows(*k5b))):
        out[f"{name}_ms"] = device_ms(fn, 20)
        out[f"{name}_digest"] = _digest(tuple(fn()))
    torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(_measure(pathlib.Path(argv[1]).resolve())))
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
    runs = {label: [] for label, _ in trees}
    for label, root in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(root)],
            cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({root}) failed:\n{proc.stderr}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(result)
        print(f"turn {label}: {json.dumps(result)}", flush=True)
    for key in runs[trees[0][0]][0]:
        print(f"{key}: " + "; ".join(
            f"{label} " + ", ".join(
                f"{r[key]:.4f}" if isinstance(r[key], float) else str(r[key])
                for r in runs[label]) for label, _ in trees), flush=True)
    print(f"on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
