"""Graph-based SLAM: edge construction, information-matrix assembly,
Gauss-Newton solve, on tensors with an optional leading seed axis.

Port of ``tpuslam/slam/graph.py`` (reference: ``TrajectoryEstimator``,
graph_based_slam.py:331-581, and the pairing loop of
``Robot.estimateOpticalTrajectory``, :685-715).  Every pair of sightings
of one landmark at two times is a pose-pair constraint; the constraints'
3x3 blocks J^T Omega J and J^T Omega e go into a dense (3T1 x 3T1)
information matrix H and vector b with a 1e4 I gauge anchor on the first
kept time, the det/cond guards decide whether the update is applied, and
the Gauss-Newton loop re-linearizes until ||dx||^2 < 0.01.

The JAX package's quirks are kept: the reference's yaw-dependent
Jacobians (the dense path never reads ``exact_jacobians``), identity
blocks on times no pair keeps, the ``gamma`` rescale of those blocks in
the cond guard, ``cond_f32_cap``, ``where`` (never a multiply) on the
delta with a non-finite delta taken as a guard failure, and per-iteration
traces padded with NaN.

Shapes: poses ``(T1, 3)`` or ``(B, T1, 3)``, observations ``(T1, L)`` or
``(B, T1, L)``; every function keeps the leading seed axis, and an
unbatched call is the one-seed case.  Where the JAX package's users
``vmap`` the ``lax.while_loop`` of :func:`graph_solve` over seeds, the
port keeps a per-seed ``active`` mask: each pass runs
:func:`gn_iteration` on every seed and only active seeds take its
results, so each seed's result is what an unbatched solve gives.  The
loop ends when no seed is active, one host synchronisation a pass.

Determinism: the pair table is static and each (i, j) pair is unique, so
assembly sums the landmark axis first, puts the off-diagonal blocks in
place by plain indexing, and forms each diagonal block and b by a
reduction in a fixed order.  No atomic scatter-add is used; two runs on
a card give the same bits.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.core.se2 import BASE_ANG
from tpuslam_torch.models.scan_sensor import ScanConfig


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Static graph-SLAM solver configuration; field for field the JAX
    package's ``GraphConfig`` (reference demo: graph_based_slam.py:604,
    630, 900-921)."""

    max_times: int  # T1: capacity of the padded time axis
    num_landmarks: int
    scan: ScanConfig = ScanConfig(
        dist_gain=0.05, dir_sigma=math.radians(2.0),
        orient_sigma=math.radians(2.0))
    anchor: float = 1.0e4  # graph_based_slam.py:475
    delta_sum_threshold: float = 0.01  # __DELTA_SUM_TH (:630)
    max_gn_iters: int = 50
    det_min: float = 0.1  # (:496)
    cond_max: float = 1.0e15  # (:496)
    #: "full": det and the SVD condition number like the reference;
    #: "cheap": slogdet and a diagonal-ratio bound; "off": no guards.
    guard: str = "full"
    #: iterative-refinement passes after the preconditioned solve.
    refine_iters: int = 1
    #: Read only by the large-scale path; the dense path keeps the
    #: reference's yaw-dependent Jacobians whatever it says.
    exact_jacobians: bool = False
    #: Levenberg-Marquardt option: solve (H + damping diag(H)) dx = -b;
    #: 0.0 is the reference's undamped solve.  Guards read the undamped H.
    damping: float = 0.0
    #: f32 solvability gate on top of ``cond_max``: a frame whose
    #: estimated cond exceeds it is rejected as the reference rejects its
    #: f64-detected singular frames (``graph.py:111-126`` of the JAX
    #: package explains the measurement behind it).
    cond_f32_cap: float = 1.0e8

    def __post_init__(self):
        if self.damping < 0.0:
            raise ValueError(
                f"GraphConfig.damping must be >= 0, got {self.damping}; "
                "negative damping subtracts from diag(H) and degrades "
                "conditioning")


class GraphObservations(typing.NamedTuple):
    """Padded landmark-sighting tensors; row t = scan at time t."""

    dist: torch.Tensor  # (..., T1, L)
    bearing: torch.Tensor  # (..., T1, L)
    orient: torch.Tensor  # (..., T1, L)
    valid: torch.Tensor  # (..., T1, L) bool


class GraphSolveResult(typing.NamedTuple):
    poses: torch.Tensor  # (..., T1, 3) updated estimates
    is_calc: torch.Tensor  # bool: last GN iteration passed the guards
    gn_iters: torch.Tensor  # int32
    delta_sum: torch.Tensor  # final ||dx||^2
    det: torch.Tensor  # det(H) of the last iteration (slogdet-safe)
    cond: torch.Tensor  # cond(H) of the last iteration
    #: Per-GN-iteration diagnostics, ``(..., max_gn_iters)``, NaN past
    #: ``gn_iters`` (the reference's "Loop(n)" printout,
    #: graph_based_slam.py:709).
    trace_delta_sum: torch.Tensor
    trace_det: torch.Tensor
    trace_cond: torch.Tensor


def upper_pairs(t1: int, device: torch.device | str | None = None):
    """Index tensors ``(pair_i, pair_j)`` of all i < j time pairs, in
    ``np.triu_indices`` order, made on ``device``."""
    iu = torch.triu_indices(t1, t1, offset=1, device=device)
    return iu[0], iu[1]


def _inv3x3(m):
    """Analytic batched 3x3 inverse via the adjugate."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 0, 2]
    d = m[..., 1, 0]
    e = m[..., 1, 1]
    f = m[..., 1, 2]
    g = m[..., 2, 0]
    h = m[..., 2, 1]
    i = m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _measurement_cov_world(cfg: GraphConfig, dist, bearing, pose_yaw):
    """World-frame sighting covariance: the diagonal measurement
    covariance rotated by bearing + yaw - BASE_ANG
    (graph_based_slam.py:175-215)."""
    sc = cfg.scan
    v0 = torch.square(dist * sc.dist_gain)
    v1 = torch.square(dist * math.sin(sc.dir_sigma))
    v2 = torch.full_like(dist, sc.dir_sigma ** 2 + sc.orient_sigma ** 2)
    ang = bearing + pose_yaw - BASE_ANG
    c, s = torch.cos(ang), torch.sin(ang)
    xx = c * c * v0 + s * s * v1
    xy = c * s * (v0 - v1)
    yy = s * s * v0 + c * c * v1
    z = torch.zeros_like(xx)
    return torch.stack([
        torch.stack([xx, xy, z], dim=-1),
        torch.stack([xy, yy, z], dim=-1),
        torch.stack([z, z, v2], dim=-1),
    ], dim=-2)


def _time_col(t_now, device) -> torch.Tensor:
    """``t_now`` (an int, or a tensor: one time or one per seed) with a
    trailing axis, to broadcast against a time axis.  An int is filled on
    the device, with no copy from the host."""
    if not isinstance(t_now, torch.Tensor):
        t_now = torch.full((), int(t_now), device=device)
    return t_now.to(device)[..., None]


@highest_matmul_precision
def build_edges(cfg: GraphConfig, poses, obs: GraphObservations, t_now,
                pair_i, pair_j):
    """Every (time pair p, landmark l) constraint at once
    (``TrajectoryEstimator.setPairObs``, graph_based_slam.py:362-439).

    Returns a dict of ``(..., P, L, 3, 3)`` blocks ``h_bb, h_ba, h_ab,
    h_aa``, ``(..., P, L, 3)`` vectors ``b_b, b_a`` (masked by validity)
    and the ``(..., P, L)`` mask.
    """
    d_b, d_a = obs.dist[..., pair_i, :], obs.dist[..., pair_j, :]
    dir_b, dir_a = obs.bearing[..., pair_i, :], obs.bearing[..., pair_j, :]
    or_b, or_a = obs.orient[..., pair_i, :], obs.orient[..., pair_j, :]
    in_time = pair_j <= _time_col(t_now, pair_j.device)
    mask = (obs.valid[..., pair_i, :] & obs.valid[..., pair_j, :]
            & in_time[..., None])

    pose_b = poses[..., pair_i, :]  # (..., P, 3)
    pose_a = poses[..., pair_j, :]
    yaw_b = pose_b[..., 2:3]  # (..., P, 1), broadcast over L
    yaw_a = pose_a[..., 2:3]

    # Relative pose from the current estimates (:398, 517-537).
    rel_rbt = pose_a - pose_b
    rel_t = wrap_angle(rel_rbt[..., 2:3])

    # Relative pose implied by the two sightings (:400-403, 539-581).
    dirw_b = wrap_angle(math.pi + dir_b - or_b)
    dirw_a = wrap_angle(math.pi + dir_a - or_a)
    orw_b = wrap_angle(BASE_ANG - or_b)
    orw_a = wrap_angle(BASE_ANG - or_a)
    rel_obs_x = d_a * torch.cos(dirw_a) - d_b * torch.cos(dirw_b)
    rel_obs_y = d_a * torch.sin(dirw_a) - d_b * torch.sin(dirw_b)
    rel_obs_t = wrap_angle(orw_a - orw_b)

    # Pose error, yaw wrapped (:406-407).
    err = torch.stack([
        rel_rbt[..., 0:1] - rel_obs_x,
        rel_rbt[..., 1:2] - rel_obs_y,
        wrap_angle(rel_t - rel_obs_t),
    ], dim=-1)  # (..., P, L, 3)

    # Omega = inv(world cov aft + world cov bfr) (:411-417).
    cov = (_measurement_cov_world(cfg, d_a, dir_a, yaw_a)
           + _measurement_cov_world(cfg, d_b, dir_b, yaw_b))
    omega = _inv3x3(cov)

    # The reference's Jacobians (:419-427).
    th_b = wrap_angle(yaw_b + dir_b)
    th_a = wrap_angle(yaw_a + dir_a)
    zero = torch.zeros_like(d_b)
    one = torch.ones_like(d_b)

    def _jac(sign, d, th):
        return torch.stack([
            torch.stack([sign * one, zero, -sign * d * torch.sin(th)], dim=-1),
            torch.stack([zero, sign * one, sign * d * torch.cos(th)], dim=-1),
            torch.stack([zero, zero, sign * one], dim=-1),
        ], dim=-2)

    j_b = _jac(-1.0, d_b, th_b)
    j_a = _jac(1.0, d_a, th_a)

    m = mask.to(poses.dtype)[..., None, None]
    jt_om_b = torch.einsum("...ji,...jk->...ik", j_b, omega)
    jt_om_a = torch.einsum("...ji,...jk->...ik", j_a, omega)
    return {
        "h_bb": torch.einsum("...ij,...jk->...ik", jt_om_b, j_b) * m,
        "h_ba": torch.einsum("...ij,...jk->...ik", jt_om_b, j_a) * m,
        "h_ab": torch.einsum("...ij,...jk->...ik", jt_om_a, j_b) * m,
        "h_aa": torch.einsum("...ij,...jk->...ik", jt_om_a, j_a) * m,
        "b_b": torch.einsum("...ij,...j->...i", jt_om_b, err) * m[..., 0],
        "b_a": torch.einsum("...ij,...j->...i", jt_om_a, err) * m[..., 0],
        "mask": mask,
    }


def kept_times(obs: GraphObservations, t_now):
    """Boolean ``(..., T1)`` of times that take part in at least one pair
    (the reference's ``KeepLandMarkTime``, graph_based_slam.py:392-395):
    time t is kept iff it validly sights a landmark sighted at >= 2 times
    up to ``t_now``."""
    t1 = obs.valid.shape[-2]
    times = torch.arange(t1, device=obs.valid.device)
    in_time = obs.valid & (times <= _time_col(t_now, times.device))[..., None]
    cnt = in_time.sum(dim=-2)  # (..., L)
    return (in_time & (cnt >= 2)[..., None, :]).any(dim=-1)


def assemble(cfg: GraphConfig, edges, kept, pair_i, pair_j, t1: int):
    """``(..., 3T1, 3T1)`` H and ``(..., 3T1)`` b from the edge blocks
    (``updateEstPose``'s block loop, graph_based_slam.py:471-492), with the
    1e4 I anchor on the first kept time (:474-475) and identity blocks on
    the times not kept.

    Each (i, j) pair is unique, so after the landmark axis is summed the
    off-diagonal blocks are placed by plain indexing; the diagonal blocks
    and b are sums over a ``(T1, T1)`` table of each time's contributions,
    a reduction in a fixed order.
    """
    h_bb, h_ba, h_ab, h_aa = (edges[k].sum(dim=-3)
                              for k in ("h_bb", "h_ba", "h_ab", "h_aa"))
    b_b, b_a = edges["b_b"].sum(dim=-2), edges["b_a"].sum(dim=-2)
    lead = h_bb.shape[:-3]
    dtype, device = h_bb.dtype, h_bb.device

    h4 = torch.zeros(lead + (t1, t1, 3, 3), dtype=dtype, device=device)
    h4[..., pair_i, pair_j, :, :] = h_ba
    h4[..., pair_j, pair_i, :, :] = h_ab
    # Row t of `own` holds time t's contributions to its diagonal block
    # (h_bb where t is the earlier time of a pair, h_aa where the later).
    own = torch.zeros_like(h4)
    own[..., pair_i, pair_j, :, :] = h_bb
    own[..., pair_j, pair_i, :, :] = h_aa
    own_b = torch.zeros(lead + (t1, t1, 3), dtype=dtype, device=device)
    own_b[..., pair_i, pair_j, :] = b_b
    own_b[..., pair_j, pair_i, :] = b_a
    b3 = own_b.sum(dim=-2)

    eye = torch.eye(3, dtype=dtype, device=device)
    diag_add = torch.where(kept, 0.0, 1.0).to(dtype)[..., None, None] * eye
    # Anchor on the first kept time (block 0 of the reference's
    # compacted, time-sorted matrix); argmax keeps the first maximum.
    first_kept = kept.to(torch.int32).argmax(dim=-1)
    times = torch.arange(t1, device=device)
    anchor = torch.where(
        (times == first_kept[..., None]) & kept.any(dim=-1, keepdim=True),
        cfg.anchor, 0.0).to(dtype)
    diag = own.sum(dim=-3) + (diag_add + anchor[..., None, None] * eye)
    h4[..., times, times, :, :] = diag

    h = h4.transpose(-3, -2).reshape(lead + (3 * t1, 3 * t1))
    return h, b3.reshape(lead + (3 * t1,))


@highest_matmul_precision
def preconditioned_solve(h, b, refine_iters: int = 1):
    """Symmetric Jacobi-preconditioned LU solve of ``h x = b`` with
    ``refine_iters`` passes of iterative refinement, batched over leading
    axes.  The scaling takes the 1e4 anchor out of the float32 solve.
    The LU is not checked (no host sync): a zero pivot gives a non-finite
    result, which :func:`gn_iteration` treats as a guard failure."""
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(d, min=1e-30))
    hs = h * s[..., :, None] * s[..., None, :]
    bs = b * s

    lu, piv, _ = torch.linalg.lu_factor_ex(hs)

    def solve(rhs):
        return torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]

    y = solve(bs)
    for _ in range(refine_iters):
        r = bs - (hs @ y[..., None])[..., 0]
        y = y + solve(r)
    return y * s


def _guards(cfg: GraphConfig, h, kept):
    """det/cond solvability guards (graph_based_slam.py:494-496):
    ``(ok, det, cond)``, each of the batch shape.

    For the cond evaluation the identity blocks of the times not kept are
    rescaled to gamma = sqrt(min_kept_diag * max_kept_diag), which lies
    inside the kept singular values' range, so the padded cond equals the
    reference's compacted one.
    """
    lead = h.shape[:-2]
    if cfg.guard == "off":
        t = torch.ones(lead, dtype=h.dtype, device=h.device)
        return torch.ones(lead, dtype=torch.bool, device=h.device), t, t
    sign, logdet = torch.linalg.slogdet(h)
    det = sign * torch.exp(torch.clamp(logdet, -80.0, 80.0))
    det_ok = (sign > 0) & (logdet > math.log(cfg.det_min))
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    kept3 = kept.repeat_interleave(3, dim=-1)
    any_kept = kept3.any(dim=-1)
    d_min = torch.where(kept3, d, math.inf).amin(dim=-1)
    d_max = torch.where(kept3, d, -math.inf).amax(dim=-1)
    gamma = torch.where(any_kept,
                        torch.sqrt(torch.clamp(d_min, min=1e-30)
                                   * torch.clamp(d_max, min=1e-30)), 1.0)
    if cfg.guard == "full":
        h_cond = h + torch.diag_embed(
            torch.where(kept3, 0.0, gamma[..., None] - 1.0))
        sv = torch.linalg.svdvals(h_cond)
        cond = sv[..., 0] / sv[..., -1]
    else:  # "cheap": diagonal ratio lower bound over the kept times
        cond = torch.where(any_kept,
                           d_max / torch.clamp(d_min, min=1e-30), 1.0)
    cond_cap = min(cfg.cond_max, cfg.cond_f32_cap)
    return det_ok & (cond < cond_cap), det, cond


@highest_matmul_precision
def gn_iteration(cfg: GraphConfig, poses, obs: GraphObservations, t_now,
                 pair_i, pair_j):
    """One Gauss-Newton iteration: relinearize, assemble, guard, solve
    (graph_based_slam.py:697-706 and ``updateEstPose``, :452-514).

    Returns ``(poses', is_calc, delta_sum, det, cond)``.
    """
    t1 = poses.shape[-2]
    kept = kept_times(obs, t_now)
    n_kept = kept.sum(dim=-1)
    edges = build_edges(cfg, poses, obs, t_now, pair_i, pair_j)
    h, b = assemble(cfg, edges, kept, pair_i, pair_j, t1)
    ok_guard, det, cond = _guards(cfg, h, kept)
    # The reference updates only with more than one kept time (:469).
    ok = ok_guard & (n_kept > 1)

    h_solve = h
    if cfg.damping:
        h_solve = h + cfg.damping * torch.diag_embed(
            torch.diagonal(h, dim1=-2, dim2=-1))
    delta = -preconditioned_solve(h_solve, b, cfg.refine_iters)
    # where(), not a multiply: NaN from a zero pivot must not leak
    # through the rows of times not kept.
    delta = torch.where(kept[..., None],
                        delta.reshape(delta.shape[:-1] + (t1, 3)), 0.0)
    # A non-finite delta is a guard failure, never an update.
    ok = ok & torch.isfinite(delta).all(dim=-1).all(dim=-1)
    delta = torch.where(ok[..., None, None], delta, 0.0)

    new_poses = poses + delta
    new_poses = torch.cat([new_poses[..., :2],
                           wrap_angle(new_poses[..., 2:3])], dim=-1)
    delta_sum = (delta * delta).sum(dim=(-2, -1))
    return new_poses, ok, delta_sum, det, cond


@highest_matmul_precision
def graph_solve(cfg: GraphConfig, poses_init, obs: GraphObservations,
                t_now=None) -> GraphSolveResult:
    """Gauss-Newton with re-linearization until ``||dx||^2 <
    threshold`` or ``max_gn_iters`` (``Robot.estimateOpticalTrajectory``,
    graph_based_slam.py:685-715); a failed guard zeroes the delta and so
    ends the loop, as in the reference.

    ``poses_init`` is ``(T1, 3)`` or ``(B, T1, 3)``; ``t_now`` is the last
    active time (default T1 - 1), a scalar or one per seed.  Each pass
    runs :func:`gn_iteration` on every seed; a seed takes the result
    while ``delta_sum >= threshold`` and it has run fewer than
    ``max_gn_iters`` passes.  The loop reads on the host whether any seed
    is still active: one synchronisation a pass, and one at the end.
    """
    t1 = poses_init.shape[-2]
    lead = poses_init.shape[:-2]
    dtype, device = poses_init.dtype, poses_init.device
    if t_now is None:
        t_now = t1 - 1
    pair_i, pair_j = upper_pairs(t1, device)
    n_max = cfg.max_gn_iters

    poses = poses_init
    ok = torch.zeros(lead, dtype=torch.bool, device=device)
    delta_sum = torch.full(lead, cfg.delta_sum_threshold, dtype=dtype,
                           device=device)
    iters = torch.zeros(lead, dtype=torch.int32, device=device)
    det = torch.zeros(lead, dtype=dtype, device=device)
    cond = torch.zeros(lead, dtype=dtype, device=device)
    traces = [torch.full(lead + (n_max,), math.nan, dtype=dtype,
                         device=device) for _ in range(3)]
    slots = torch.arange(n_max, device=device)
    while True:
        active = (delta_sum >= cfg.delta_sum_threshold) & (iters < n_max)
        if not bool(active.any()):
            break
        new_poses, new_ok, new_ds, new_det, new_cond = gn_iteration(
            cfg, poses, obs, t_now, pair_i, pair_j)
        poses = torch.where(active[..., None, None], new_poses, poses)
        ok = torch.where(active, new_ok, ok)
        delta_sum = torch.where(active, new_ds, delta_sum)
        det = torch.where(active, new_det, det)
        cond = torch.where(active, new_cond, cond)
        slot = (slots == iters[..., None]) & active[..., None]
        traces = [torch.where(slot, v[..., None], buf) for buf, v in
                  zip(traces, (new_ds, new_det, new_cond))]
        iters = iters + active.to(torch.int32)
    return GraphSolveResult(poses=poses, is_calc=ok, gn_iters=iters,
                            delta_sum=delta_sum, det=det, cond=cond,
                            trace_delta_sum=traces[0], trace_det=traces[1],
                            trace_cond=traces[2])
