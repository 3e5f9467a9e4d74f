"""The fused batched EKF rollout: K1 as a CUDA kernel and its plain twin.

Port of ``tpuslam/ops/ekf_pallas.py``.  :func:`ekf_fused_rollout` runs
``batch`` independent rollouts of ``n_steps`` fused sim+filter steps in
one launch of ``csrc/ekf_rollout.cu`` (see that file for the design) and
returns the JAX package's public shapes.  :func:`ekf_fused_rollout_plain`
is the same computation in plain torch: it uses the kernel's arithmetic
(polynomial sincos with noise on, builtin trig with noise off, the same
wrap placement) and, with noise on, the kernel's Philox stream, so the two
differ only by rounding (the kernel's compiler contracts ``a*b + c`` into
FMAs; torch's elementwise ops do not).

Dispatch is by device: a CPU device runs the plain version; a CUDA device
launches the kernel or raises.  There is no fallback from one to the
other.

A launch reuses one plan per ``(cfg, n_steps, device)``: the kernel
library, the truth table, the kernel's parameters filled from the config
and the device's SM count.  A call adds only its own: the batch and seed
(the library's entry folds the seed into the Philox round keys) and a
fresh output buffer, launched by ``_build.launch``.

K1 has two forms of one computation, with the same output words: a
thread a rollout, and the small-batch form, four lanes of a warp a
rollout, for batches that leave most of the card's warp schedulers
empty at a thread a rollout.  :func:`k1_lanes` picks the form from the
batch and the SM count.

Spans (:func:`~tpuslam_torch.utils.profiling.span`, recorded only while a
profiler records): ``tpuslam.ekf.rollout`` around
:func:`ekf_fused_rollout`; inside its launch ``tpuslam.ekf.params`` (the
plan lookup and the output buffer) and ``tpuslam.ekf.launch`` (the stream
and the kernel call); ``tpuslam.ekf.plan`` where a plan is built, holding
``tpuslam.ekf.truth_table`` where a truth table is built.

Noise: with ``noise_on`` and no ``normals``, the normals come by
Box-Muller from Philox4x32-10 keyed by ``seed``, with the counter
``(rollout index, step, draw, 0)``.  A step's five normals are, in order,
the observation's x and y (``n0``, ``n1``) and the dead reckoning's x, y
and yaw (``n2``, ``n3``, ``n4``):

* draw 0 of step k gives two Box-Muller pairs, ``n0, n1`` and
  ``n2, n3``;
* draw 1 runs at even steps only.  Its first two words give one pair:
  the first normal is step k's ``n4``, the second is step k+1's ``n4``.
  Its last two words are not used.  With an odd ``n_steps`` the last
  pair's second normal goes unused.

So two steps take three Philox calls and five transforms
(:func:`philox_normals` gives the stream).  ``normals`` of shape ``(n_steps, 5, batch)`` replaces that stream (the
same row order), so the kernel and the plain version can be compared with
noise on.
"""

from __future__ import annotations

import ctypes

import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.filters.ekf import EkfConfig, EkfState
from tpuslam_torch.ops import _build
from tpuslam_torch.ops._build import MODE_NORMALS, MODE_OFF, MODE_PHILOX
from tpuslam_torch.ops.fastmath import (_MASK32, normals_from_bits,
                                        philox4x32, sincos_rad)
from tpuslam_torch.utils.profiling import span

#: K1 takes its small-batch form below this many rollouts an SM, so that
#: no SM holds more than three of its 32-rollout blocks (12 warps).  On an
#: H100 at 400 steps it beats the one-thread form up to 12,288 rollouts
#: (240 against 280 us with NEES) and loses from 14,336 (305 against
#: 280), where some SMs hold four.
LANES_BELOW_PER_SM = 96
_ROUNDS = 10  # Philox4x32-10's rounds, a round key each


class _EkfParams(ctypes.Structure):
    """Mirror of ``EkfParams`` in ``csrc/ekf_rollout.cu``."""

    _fields_ = [("batch", ctypes.c_longlong), ("n_steps", ctypes.c_int),
                ("rk0", ctypes.c_uint32 * _ROUNDS),
                ("rk1", ctypes.c_uint32 * _ROUNDS)] + [
        (name, ctypes.c_float) for name in (
            "vdt", "wdt", "q0", "q1", "q2", "r0sq", "r1sq", "qa0", "qa1",
            "qa2", "ra0", "ra1", "x0", "x1", "x2", "p00", "p11", "p22")]


def k1_lanes(batch: int, sm_count: int) -> int:
    """The lanes a rollout of K1's form for ``batch`` rollouts on a card
    of ``sm_count`` SMs: 4 (the small-batch form) below
    :data:`LANES_BELOW_PER_SM` rollouts an SM, else 1.  Both forms give
    the same output words."""
    return 4 if batch < LANES_BELOW_PER_SM * sm_count else 1


def _constants(cfg: EkfConfig) -> dict:
    """The kernel's scalar constants as Python floats.

    ``v*dt``, ``w*dt`` and the squared filter stds are folded in double,
    as the JAX kernel's weakly typed Python scalars are; torch and the
    C interface then round each once to float32.  The initial pose and
    covariance diagonal are float32 values, squared in float32 like the
    JAX wrapper's.
    """
    q0, q1, q2 = (s * s for s in cfg.q_std)
    r0sq, r1sq = (s * s for s in cfg.r_std)
    qa0, qa1, qa2 = cfg.q_act_std
    ra0, ra1 = cfg.r_act_std
    x0, x1, x2 = torch.tensor(cfg.x0, dtype=torch.float32).tolist()
    p00, p11, p22 = torch.tensor(
        cfg.p0_std, dtype=torch.float32).square().tolist()
    return dict(vdt=cfg.vel * cfg.dt, wdt=cfg.yaw_rate * cfg.dt, q0=q0,
                q1=q1, q2=q2, r0sq=r0sq, r1sq=r1sq, qa0=qa0, qa1=qa1,
                qa2=qa2, ra0=ra0, ra1=ra1, x0=x0, x1=x1, x2=x2, p00=p00,
                p11=p11, p22=p22)


def truth_table(cfg: EkfConfig, n_steps: int,
                device: torch.device | str) -> torch.Tensor:
    """``(n_steps, 5)`` float32 rows ``[xt0, xt1, xt2, cos xt2, sin xt2]``
    of the noise-free ground truth after each step.

    The truth is the same for every rollout, so it is computed once per
    configuration on the device, by the plain torch ops of
    ``models/process.py``'s circular step, and kept.
    """
    device = _build.resolve_device(device)

    def build():
        with span("tpuslam.ekf.truth_table"):
            vdt, wdt = cfg.vel * cfg.dt, cfg.yaw_rate * cfg.dt
            t0, t1, t2 = torch.tensor(cfg.x0, dtype=torch.float32,
                                      device=device).unbind()
            rows = []
            for _ in range(n_steps):
                t0 = t0 + vdt * torch.cos(t2)
                t1 = t1 + vdt * torch.sin(t2)
                t2 = wrap_angle(t2 + wdt)
                rows.append(torch.stack([t0, t1, t2, torch.cos(t2),
                                         torch.sin(t2)]))
            return torch.stack(rows).contiguous()
    return _build.cached(("ekf_truth", cfg, n_steps, device), build)


def _check(batch: int, n_steps: int, normals: torch.Tensor | None,
           device: torch.device) -> None:
    if batch < 1 or n_steps < 1:
        raise ValueError(f"batch {batch} and n_steps {n_steps} must be "
                         "positive")
    if batch > _MASK32:
        raise ValueError(f"batch {batch} exceeds the 32-bit Philox "
                         "counter word")
    if normals is not None:
        _build.check_tensor("normals", normals, (n_steps, 5, batch),
                            torch.float32, device)


def _finish(state: torch.Tensor, cov: torch.Tensor, err: torch.Tensor,
            with_nees: bool):
    """SoA ``(9, B)``, ``(9, B)``, ``(2, B)`` buffers -> public shapes."""
    batch = state.shape[1]
    final = EkfState(x_true=state[0:3].T, x_dr=state[3:6].T,
                     x_hat=state[6:9].T, cov=cov.T.reshape(batch, 3, 3))
    if with_nees:
        return final, err[0], err[1]
    return final, err[0]


def _philox_steps(seed: int, batch: int, n_steps: int,
                  device: torch.device):
    """Yield each step's five normals ``(n0, ..., n4)`` of the Philox
    stream, ``(batch,)`` float32 each, in the layout of the module's
    docstring."""
    idx = torch.arange(batch, dtype=torch.int64, device=device)
    k0, k1 = _build.seed_words(seed)
    for k in range(n_steps):
        a = philox4x32(idx, k, 0, 0, k0, k1)
        n0, n1 = normals_from_bits(a[0], a[1])
        n2, n3 = normals_from_bits(a[2], a[3])
        if k % 2 == 0:
            b = philox4x32(idx, k, 1, 0, k0, k1)
            n4, n4_next = normals_from_bits(b[0], b[1])
        else:
            n4 = n4_next
        yield n0, n1, n2, n3, n4


def philox_normals(seed: int, batch: int, n_steps: int, *,
                   device: torch.device | str) -> torch.Tensor:
    """The ``(n_steps, 5, batch)`` float32 normals that a noise-on
    rollout under ``seed`` draws, in the row order of ``normals``:
    passing them as ``normals`` gives the Philox rollout's result."""
    device = _build.resolve_device(device)
    return torch.stack([torch.stack(step) for step in
                        _philox_steps(int(seed), batch, n_steps, device)])


def ekf_fused_rollout_plain(cfg: EkfConfig, seed: int, batch: int,
                            n_steps: int, noise_on: bool = True,
                            with_nees: bool = False,
                            normals: torch.Tensor | None = None, *,
                            device: torch.device | str):
    """The kernel's computation in plain torch, on any device.

    Same arguments and returns as :func:`ekf_fused_rollout`.
    """
    device = _build.resolve_device(device)
    _check(batch, n_steps, normals, device)
    mode = _build.noise_mode(noise_on, normals)
    tbl = truth_table(cfg, n_steps, device)
    c = _constants(cfg)
    vdt, wdt = c["vdt"], c["wdt"]

    def full(value):
        return torch.full((batch,), value, dtype=torch.float32,
                          device=device)

    zero = full(0.0)
    xd0, xd1, xd2 = full(c["x0"]), full(c["x1"]), full(c["x2"])
    xh0, xh1, xh2 = xd0, xd1, xd2
    p00, p01, p02 = full(c["p00"]), zero, zero
    p10, p11, p12 = zero, full(c["p11"]), zero
    p20, p21, p22 = zero, zero, full(c["p22"])
    acc = acc_n = zero
    n0 = n1 = n2 = n3 = n4 = zero
    if mode == MODE_PHILOX:
        stream = _philox_steps(seed, batch, n_steps, device)

    for k in range(n_steps):
        if mode == MODE_PHILOX:
            n0, n1, n2, n3, n4 = next(stream)
        elif mode == MODE_NORMALS:
            n0, n1, n2, n3, n4 = normals[k].unbind()
        xt0, xt1, _, c_t, s_t = tbl[k].unbind()

        wx = n0 * c["ra0"]
        wy = n1 * c["ra1"]
        z0 = s_t * wx + c_t * wy + xt0
        z1 = -c_t * wx + s_t * wy + xt1

        if mode == MODE_OFF:
            c_d, s_d = torch.cos(xd2), torch.sin(xd2)
        else:
            c_d, s_d = sincos_rad(xd2)
        xd0 = xd0 + vdt * c_d + n2 * c["qa0"]
        xd1 = xd1 + vdt * s_d + n3 * c["qa1"]
        xd2 = wrap_angle(xd2 + wdt + n4 * c["qa2"])

        if mode == MODE_OFF:
            c_h, s_h = torch.cos(xh2), torch.sin(xh2)
        else:
            c_h, s_h = sincos_rad(xh2)
        xp0 = xh0 + vdt * c_h
        xp1 = xh1 + vdt * s_h
        xp2 = wrap_angle(xh2 + wdt)
        a_j = -vdt * s_h
        b_j = vdt * c_h
        m00 = p00 + a_j * p20
        m01 = p01 + a_j * p21
        m02 = p02 + a_j * p22
        m10 = p10 + b_j * p20
        m11 = p11 + b_j * p21
        m12 = p12 + b_j * p22
        p00 = m00 + a_j * m02 + c["q0"]
        p01 = m01 + b_j * m02
        p02 = m02
        p10 = m10 + a_j * m12
        p11 = m11 + b_j * m12 + c["q1"]
        p12 = m12
        p20, p21, p22 = p20 + a_j * p22, p21 + b_j * p22, p22 + c["q2"]

        s00 = p00 + c["r0sq"]
        s01 = p01
        s10 = p10
        s11 = p11 + c["r1sq"]
        det = s00 * s11 - s01 * s10
        inv = 1.0 / det
        i00 = s11 * inv
        i01 = -s01 * inv
        i10 = -s10 * inv
        i11 = s00 * inv
        g00 = p00 * i00 + p01 * i10
        g01 = p00 * i01 + p01 * i11
        g10 = p10 * i00 + p11 * i10
        g11 = p10 * i01 + p11 * i11
        g20 = p20 * i00 + p21 * i10
        g21 = p20 * i01 + p21 * i11
        e0 = z0 - xp0
        e1 = z1 - xp1
        xh0 = xp0 + g00 * e0 + g01 * e1
        xh1 = xp1 + g10 * e0 + g11 * e1
        xh2 = wrap_angle(xp2 + g20 * e0 + g21 * e1)
        p00, p01, p02, p10, p11, p12, p20, p21, p22 = (
            p00 - (g00 * p00 + g01 * p10),
            p01 - (g00 * p01 + g01 * p11),
            p02 - (g00 * p02 + g01 * p12),
            p10 - (g10 * p00 + g11 * p10),
            p11 - (g10 * p01 + g11 * p11),
            p12 - (g10 * p02 + g11 * p12),
            p20 - (g20 * p00 + g21 * p10),
            p21 - (g20 * p01 + g21 * p11),
            p22 - (g20 * p02 + g21 * p12))

        d0 = xh0 - xt0
        d1 = xh1 - xt1
        acc = acc + d0 * d0 + d1 * d1
        if with_nees:
            det_n = p00 * p11 - p01 * p10
            acc_n = acc_n + (p11 * d0 * d0 - (p01 + p10) * d0 * d1
                             + p00 * d1 * d1) / det_n

    xt_last = tbl[n_steps - 1, :3, None].expand(3, batch)
    state = torch.cat([xt_last, torch.stack([xd0, xd1, xd2, xh0, xh1,
                                             xh2])])
    cov = torch.stack([p00, p01, p02, p10, p11, p12, p20, p21, p22])
    return _finish(state, cov, torch.stack([acc, acc_n]), with_nees)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(cfg: EkfConfig, n_steps: int,
          device: torch.device) -> _build.Plan:
    """K1's launch plan for ``(cfg, n_steps, device)``, built at its first
    launch in the span ``tpuslam.ekf.plan`` (``_build.builds["ekf_plan"]``
    counts the builds): the parameters from :func:`_constants`, rounded to
    float32 once by ``ctypes``, batch and round keys left 0 for the entry
    to set; its ``extra`` the truth table (kept alive for its pointer),
    the table's pointer and the device's SM count."""
    def make_extra():
        tbl = truth_table(cfg, n_steps, device)
        return tbl, tbl.data_ptr(), _sm_count(device)
    return _build.plan(
        ("ekf_plan", cfg, n_steps, device), device, "tpuslam_ekf_rollout",
        lambda: _EkfParams(n_steps=n_steps, **_constants(cfg)), make_extra,
        "tpuslam.ekf.plan")


def _launch(cfg: EkfConfig, seed: int, batch: int, n_steps: int, mode: int,
            with_nees: bool, normals: torch.Tensor | None,
            device: torch.device):
    with span("tpuslam.ekf.params"):
        plan = _plan(cfg, n_steps, device)
        # One fresh buffer a call, rows 0:9 the state, 9:18 the
        # covariance, 18:20 the accumulators; the views are taken after
        # the launch, which reads only their addresses.
        out = torch.empty((20, batch), dtype=torch.float32, device=device)
    with span("tpuslam.ekf.launch"):
        ptr, row = out.data_ptr(), 4 * batch
        _, table_ptr, sm_count = plan.extra
        lanes = k1_lanes(batch, sm_count)
        _build.launch("ekf_rollout_lanes" if lanes > 1 else "ekf_rollout",
                      plan.entry, plan.index, table_ptr,
                      _build.ptr(normals), ptr, ptr + 9 * row,
                      ptr + 18 * row, plan.params_ptr, batch,
                      *_build.seed_words(seed), mode, int(with_nees), lanes)
    return _finish(out[0:9], out[9:18], out[18:20], with_nees)


def ekf_fused_rollout(cfg: EkfConfig, seed: int, batch: int, n_steps: int,
                      noise_on: bool = True, with_nees: bool = False,
                      normals: torch.Tensor | None = None, *,
                      device: torch.device | str):
    """Run ``batch`` fused EKF rollouts of ``n_steps`` in one launch.

    Args:
        cfg: EKF config (reference defaults).
        seed: integer key of the Philox noise stream.
        batch: number of independent rollouts (any positive size).
        n_steps: steps per rollout.
        noise_on: False gives the deterministic noise-free trajectory.
        with_nees: also return the summed posterior position NEES.
        normals: optional ``(n_steps, 5, batch)`` float32 normals used in
            place of the Philox stream (noise on only).
        device: required; a CUDA device launches the kernel, the CPU
            runs :func:`ekf_fused_rollout_plain`.  There is no default, so
            no caller lands on the plain path by leaving it out.

    Returns:
        ``(EkfState, sum_sq_err)``: the final state (``(batch, 3)`` poses,
        ``(batch, 3, 3)`` covariance) and the ``(batch,)`` summed squared
        posterior position error (divide by ``n_steps`` and take the root
        for the per-rollout RMSE).  With ``with_nees=True``,
        ``(EkfState, sum_sq_err, sum_nees)``.
    """
    with span("tpuslam.ekf.rollout"):
        device = _build.resolve_device(device)
        seed = int(seed)
        if device.type == "cpu":
            return ekf_fused_rollout_plain(cfg, seed, batch, n_steps,
                                           noise_on, with_nees, normals,
                                           device=device)
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        _check(batch, n_steps, normals, device)
        return _launch(cfg, seed, batch, n_steps,
                       _build.noise_mode(noise_on, normals), with_nees,
                       normals, device)


def ekf_fused_sweeps(cfg: EkfConfig, seed: int, n_sweeps: int, batch: int,
                     n_steps: int, noise_on: bool = True, *,
                     device: torch.device | str):
    """Run ``n_sweeps`` independent Monte-Carlo sweeps in one launch.

    Returns:
        ``(EkfState, rmse)``: the final state of all
        ``n_sweeps * batch`` rollouts, sweep-major, and the
        ``(n_sweeps,)`` per-sweep position RMSE.
    """
    final, err = ekf_fused_rollout(cfg, seed, n_sweeps * batch, n_steps,
                                   noise_on=noise_on, device=device)
    rmse = torch.sqrt(err.reshape(n_sweeps, batch).mean(dim=1) / n_steps)
    return final, rmse
