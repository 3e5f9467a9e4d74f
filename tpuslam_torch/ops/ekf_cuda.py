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

Noise: with ``noise_on`` and no ``normals``, each step draws five normals
by Box-Muller from Philox4x32-10 keyed by ``seed``, with the counter
``(rollout index, step, draw, 0)``.  ``normals`` of shape
``(n_steps, 5, batch)`` replaces that stream (row order: two observation,
three dead-reckoning normals), so the kernel and the plain version can be
compared with noise on.
"""

from __future__ import annotations

import ctypes

import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.filters.ekf import EkfConfig, EkfState
from tpuslam_torch.ops import _build
from tpuslam_torch.ops.fastmath import (normals_from_bits, philox4x32,
                                        sincos_rad)

#: Launches of the CUDA kernel since this count was last set to 0.
launch_count = 0

_MODE_OFF, _MODE_PHILOX, _MODE_NORMALS = 0, 1, 2
_MASK32 = 0xFFFFFFFF

# Truth tables by (cfg, n_steps, device): one small tensor per
# configuration, built once on the device.
_TABLES: dict = {}


class _EkfParams(ctypes.Structure):
    """Mirror of ``EkfParams`` in ``csrc/ekf_rollout.cu``."""

    _fields_ = [("batch", ctypes.c_longlong), ("n_steps", ctypes.c_int),
                ("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)] + [
        (name, ctypes.c_float) for name in (
            "vdt", "wdt", "q0", "q1", "q2", "r0sq", "r1sq", "qa0", "qa1",
            "qa2", "ra0", "ra1", "x0", "x1", "x2", "p00", "p11", "p22")]


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
    device = _resolve(device)
    key = (cfg, n_steps, device)
    tbl = _TABLES.get(key)
    if tbl is None:
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
        tbl = _TABLES[key] = torch.stack(rows).contiguous()
    return tbl


def _resolve(device: torch.device | str) -> torch.device:
    """``device`` with the current CUDA index filled in where it has none."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.is_available()):
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _mode(noise_on: bool, normals: torch.Tensor | None) -> int:
    if normals is not None:
        if not noise_on:
            raise ValueError("normals given with noise_on=False")
        return _MODE_NORMALS
    return _MODE_PHILOX if noise_on else _MODE_OFF


def _check(batch: int, n_steps: int, normals: torch.Tensor | None,
           device: torch.device) -> None:
    if batch < 1 or n_steps < 1:
        raise ValueError(f"batch {batch} and n_steps {n_steps} must be "
                         "positive")
    if batch > _MASK32:
        raise ValueError(f"batch {batch} exceeds the 32-bit Philox "
                         "counter word")
    if normals is not None:
        if normals.shape != (n_steps, 5, batch):
            raise ValueError(f"normals shape {tuple(normals.shape)} != "
                             f"{(n_steps, 5, batch)}")
        if normals.dtype != torch.float32:
            raise ValueError(f"normals dtype {normals.dtype} != float32")
        if normals.device != device:
            raise ValueError(f"normals on {normals.device}, rollout on "
                             f"{device}")
        if not normals.is_contiguous():
            raise ValueError("normals must be contiguous")


def _finish(state: torch.Tensor, cov: torch.Tensor, err: torch.Tensor,
            with_nees: bool):
    """SoA ``(9, B)``, ``(9, B)``, ``(2, B)`` buffers -> public shapes."""
    batch = state.shape[1]
    final = EkfState(x_true=state[0:3].T, x_dr=state[3:6].T,
                     x_hat=state[6:9].T, cov=cov.T.reshape(batch, 3, 3))
    if with_nees:
        return final, err[0], err[1]
    return final, err[0]


def ekf_fused_rollout_plain(cfg: EkfConfig, seed: int, batch: int,
                            n_steps: int, noise_on: bool = True,
                            with_nees: bool = False,
                            normals: torch.Tensor | None = None, *,
                            device: torch.device | str):
    """The kernel's computation in plain torch, on any device.

    Same arguments and returns as :func:`ekf_fused_rollout`.
    """
    device = _resolve(device)
    _check(batch, n_steps, normals, device)
    mode = _mode(noise_on, normals)
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
    if mode == _MODE_PHILOX:
        idx = torch.arange(batch, dtype=torch.int64, device=device)
        k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32

    for k in range(n_steps):
        if mode == _MODE_PHILOX:
            a = philox4x32(idx, k, 0, 0, k0, k1)
            b = philox4x32(idx, k, 1, 0, k0, k1)
            n0, n1 = normals_from_bits(a[0], a[1])
            n2, n3 = normals_from_bits(a[2], a[3])
            n4, _ = normals_from_bits(b[0], b[1])
        elif mode == _MODE_NORMALS:
            n0, n1, n2, n3, n4 = normals[k].unbind()
        xt0, xt1, _, c_t, s_t = tbl[k].unbind()

        wx = n0 * c["ra0"]
        wy = n1 * c["ra1"]
        z0 = s_t * wx + c_t * wy + xt0
        z1 = -c_t * wx + s_t * wy + xt1

        if mode == _MODE_OFF:
            c_d, s_d = torch.cos(xd2), torch.sin(xd2)
        else:
            c_d, s_d = sincos_rad(xd2)
        xd0 = xd0 + vdt * c_d + n2 * c["qa0"]
        xd1 = xd1 + vdt * s_d + n3 * c["qa1"]
        xd2 = wrap_angle(xd2 + wdt + n4 * c["qa2"])

        if mode == _MODE_OFF:
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


def _launch(cfg: EkfConfig, seed: int, batch: int, n_steps: int, mode: int,
            with_nees: bool, normals: torch.Tensor | None,
            device: torch.device):
    global launch_count
    if not torch.cuda.is_available():
        raise RuntimeError(f"rollout on {device} requested but CUDA is not "
                           "available")
    lib = _build.load_library()
    with torch.cuda.device(device):
        tbl = truth_table(cfg, n_steps, device)
        f32 = dict(dtype=torch.float32, device=device)
        state = torch.empty((9, batch), **f32)
        cov = torch.empty((9, batch), **f32)
        err = torch.empty((2, batch), **f32)
        params = _EkfParams(batch=batch, n_steps=n_steps,
                            key0=seed & _MASK32,
                            key1=(seed >> 32) & _MASK32,
                            **_constants(cfg))
        rc = lib.tpuslam_ekf_rollout(
            tbl.data_ptr(), None if normals is None else normals.data_ptr(),
            state.data_ptr(), cov.data_ptr(), err.data_ptr(),
            ctypes.addressof(params), mode, int(with_nees),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ekf_rollout kernel launch failed: CUDA error "
                           f"{rc}")
    launch_count += 1
    return _finish(state, cov, err, with_nees)


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
    device = _resolve(device)
    seed = int(seed)
    if device.type == "cpu":
        return ekf_fused_rollout_plain(cfg, seed, batch, n_steps, noise_on,
                                       with_nees, normals, device=device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check(batch, n_steps, normals, device)
    return _launch(cfg, seed, batch, n_steps, _mode(noise_on, normals),
                   with_nees, normals, device)


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
