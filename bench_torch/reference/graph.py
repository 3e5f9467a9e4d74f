"""The plain reference of the large-scale graph-SLAM solve (``graph_large``).

One scene at a time, in float64, on a dense information matrix: every pair
of sightings of one landmark at most ``window`` poses apart is a
constraint between the two poses (graph_based_slam.py:685-715, windowed as
bench.py:191 windows it).  A constraint's residual is the exact-linear
one, ``(pose_a - pose_b) - rel_obs`` with the yaw wrapped, so its blocks
are ``+/-Omega``, with the sighting information ``Omega`` taken once at
the initial guess (the frozen Omega of the cell's configuration).  The
odometry chain adds ``(pose[t+1] - pose[t]) - rel_odom[t]`` with diagonal
information ``odom_info``.  A time that no sighting pair touches gets an
identity block, and the gauge anchor ``anchor * I`` sits on the first time
one does (graph_based_slam.py:474-475).  H is constant, so it is factored
once (``torch.linalg.cholesky``); each Gauss-Newton pass rebuilds b from
the current poses and solves.  The stop rule is the configuration's: at
most ``max_gn_iters`` passes, stop once ``delta_sum`` (the squared update,
yaw wrapped) falls below ``delta_tol``, or once it is at least
``stall_ratio`` times the previous one after two passes.

The scene is drawn here too, in float64, from the run's draws (landmark
offsets, their angular slots, the scan and odometry normals): the true
circle, the landmarks, the odometry drift and each pose's scan
(graph_based_slam.py:128-172, 903-907).  A sighting whose visibility lies
within ``margin`` of the sensor's range or sector edge is a tie: float32
rounding of the program's scene may decide it either way, and the caller
gives the program's decision there.

The control (``dtype`` below float32) rounds the edge terms, H and each
pass's b through that dtype; the solve itself stays in float64.  Nothing
here imports the program.
"""

from __future__ import annotations

import math

import torch

from reference.ekf import wrap

BASE_ANG = math.pi / 2.0


def course(t1: int, radius: float, device) -> torch.Tensor:
    """The true ``(T1, 3)`` course: the reference robot's circle of
    ``radius`` scaled to T1 poses, heading along it (world +y at t = 0)."""
    phi = (2.0 * math.pi / t1) * torch.arange(t1, dtype=torch.float64,
                                              device=device)
    return torch.stack([radius * torch.cos(phi), radius * torch.sin(phi),
                        wrap(phi + BASE_ANG)], dim=-1)


def scene(scene_cfg: dict, lm_offsets, lm_perm, scan_normals, odom_normals,
          margin: float = 0.01) -> dict:
    """One scene from its draws, in float64.

    Args:
        scene_cfg: the configuration's ``scene`` (``poses``,
            ``landmarks``, ``radius_frac``, ``odom_noise``, ``scan``).
        lm_offsets: ``(L,)`` landmark radius offsets.
        lm_perm: ``(L,)`` each landmark's angular slot.
        scan_normals: ``(T1, L, 3)`` standard normals (distance, bearing,
            orientation); odom_normals: ``(T1, 3)``.
        margin: metres within which a sighting's visibility is a tie.

    Returns ``{"truth", "odometry" (T1, 3), "rel_odom" (T1-1, 3), "obs":
    {dist, bearing, orient, valid (T1, L)}, "tie" (T1, L)}``.
    """
    f64 = torch.float64
    t1, n_lm = scene_cfg["poses"], scene_cfg["landmarks"]
    radius = scene_cfg["radius_frac"] * t1
    scan = scene_cfg["scan"]
    dev = lm_offsets.device
    truth = course(t1, radius, dev)
    r_lm = radius + lm_offsets.to(f64)
    a_lm = (2.0 * math.pi / n_lm) * lm_perm.to(f64)
    lm = torch.stack([r_lm * torch.cos(a_lm), r_lm * torch.sin(a_lm)], -1)

    odo = truth + torch.cumsum(odom_normals.to(f64)
                               * scene_cfg["odom_noise"], dim=0)
    odo = torch.stack([odo[:, 0], odo[:, 1], wrap(odo[:, 2])], dim=-1)
    rel = odo[1:] - odo[:-1]
    rel = torch.stack([rel[:, 0], rel[:, 1], wrap(rel[:, 2])], dim=-1)

    # The robot frame: +y along the heading, +x to its right.
    yaw = truth[:, 2:3]
    d = lm[None, :, :] - truth[:, None, :2]  # (T1, L, 2)
    fwd = d[..., 0] * torch.cos(yaw) + d[..., 1] * torch.sin(yaw)
    right = d[..., 0] * torch.sin(yaw) - d[..., 1] * torch.cos(yaw)
    dist = torch.sqrt(fwd * fwd + right * right)
    edge_range = dist - scan["range_m"]
    edge_sector = fwd - right.abs() * math.tan(BASE_ANG - scan["angle_rad"])
    valid = (edge_range <= 0.0) & (edge_sector >= 0.0)
    tie = (edge_range.abs() < margin) | (edge_sector.abs() < margin)
    n = scan_normals.to(f64)
    obs = {"dist": dist + n[..., 0] * dist * scan["dist_gain"],
           "bearing": wrap(torch.atan2(fwd, right)
                           + n[..., 1] * scan["dir_sigma"]),
           "orient": wrap(BASE_ANG - yaw + n[..., 2] * scan["orient_sigma"]),
           "valid": valid}
    return {"truth": truth, "odometry": odo, "rel_odom": rel, "obs": obs,
            "tie": tie}


def windowed_edges(valid: torch.Tensor, window: int):
    """``(t_b, t_a, lm)`` of every pair of times at most ``window`` apart
    at which landmark ``lm`` is seen, lag by lag."""
    t1 = valid.shape[0]
    tb, ta, lm = [], [], []
    for d in range(1, min(window, t1 - 1) + 1):
        t, m = torch.nonzero(valid[:-d] & valid[d:], as_tuple=True)
        tb.append(t)
        ta.append(t + d)
        lm.append(m)
    return torch.cat(tb), torch.cat(ta), torch.cat(lm)


def _sighting_cov(scan: dict, dist, bearing, yaw):
    """World-frame ``(E, 3, 3)`` covariance of one sighting: diag((d
    gain)^2, (d sin(dir_sigma))^2, dir_sigma^2 + orient_sigma^2) rotated
    about z by bearing + yaw - BASE_ANG (graph_based_slam.py:175-215)."""
    e = dist.shape[0]
    cov = torch.zeros((e, 3, 3), dtype=dist.dtype, device=dist.device)
    cov[:, 0, 0] = (dist * scan["dist_gain"]) ** 2
    cov[:, 1, 1] = (dist * math.sin(scan["dir_sigma"])) ** 2
    cov[:, 2, 2] = scan["dir_sigma"] ** 2 + scan["orient_sigma"] ** 2
    ang = bearing + yaw - BASE_ANG
    c, s = torch.cos(ang), torch.sin(ang)
    rot = torch.zeros_like(cov)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
    rot[:, 2, 2] = 1.0
    return rot @ cov @ rot.mT


def _round(x: torch.Tensor, via: torch.dtype | None) -> torch.Tensor:
    return x if via is None else x.to(via).to(x.dtype)


def solve(scene: dict, poses_init, obs: dict, rel_odom, window: int,
          via: torch.dtype | None = None) -> dict:
    """Gauss-Newton on one scene.

    Args:
        scene: the configuration's ``scene`` (``scan``, ``anchor``,
            ``odom_info``, ``max_gn_iters``, ``delta_tol``,
            ``stall_ratio``).
        poses_init: ``(T1, 3)`` initial guess (the odometry).
        obs: ``dist``, ``bearing``, ``orient`` ``(T1, L)`` and ``valid``.
        rel_odom: ``(T1-1, 3)`` odometry increments.
        via: round the edge terms, H and b through this dtype (the
            control).

    Returns ``{"poses" (T1, 3), "gn_iters", "delta_sum"}``, float64.
    """
    f64 = torch.float64
    x = poses_init.to(f64)
    t1 = x.shape[0]
    dev = x.device
    tb, ta, lm = windowed_edges(obs["valid"], window)
    d_b, d_a = obs["dist"][tb, lm].to(f64), obs["dist"][ta, lm].to(f64)
    r_b, r_a = obs["bearing"][tb, lm].to(f64), obs["bearing"][ta, lm].to(f64)
    o_b, o_a = obs["orient"][tb, lm].to(f64), obs["orient"][ta, lm].to(f64)

    # Each sighting's displacement in the world frame, from the bearing and
    # the orientation of world +y in the robot frame.
    dwb, dwa = wrap(math.pi + r_b - o_b), wrap(math.pi + r_a - o_a)
    owb, owa = wrap(BASE_ANG - o_b), wrap(BASE_ANG - o_a)
    rel_obs = torch.stack([d_a * torch.cos(dwa) - d_b * torch.cos(dwb),
                           d_a * torch.sin(dwa) - d_b * torch.sin(dwb),
                           wrap(owa - owb)], dim=-1)
    cov = (_sighting_cov(scene["scan"], d_a, r_a, x[ta, 2])
           + _sighting_cov(scene["scan"], d_b, r_b, x[tb, 2]))
    omega = _round(torch.linalg.inv(cov), via)
    rel_obs = _round(rel_obs, via)

    # Dense H: +Omega on both diagonal blocks, -Omega on both couplings.
    n = 3 * t1
    h = torch.zeros((n, n), dtype=f64, device=dev)
    i3 = torch.arange(3, device=dev)
    rows_b = (3 * tb[:, None, None] + i3[:, None]).expand(-1, 3, 3)
    rows_a = (3 * ta[:, None, None] + i3[:, None]).expand(-1, 3, 3)
    cols_b, cols_a = rows_b.mT, rows_a.mT
    for r, c, sign in ((rows_b, cols_b, 1.0), (rows_a, cols_a, 1.0),
                       (rows_b, cols_a, -1.0), (rows_a, cols_b, -1.0)):
        h.index_put_((r.reshape(-1), c.reshape(-1)),
                     (sign * omega).reshape(-1), accumulate=True)
    kept = torch.zeros(t1, dtype=torch.bool, device=dev)
    kept[tb] = True
    kept[ta] = True
    diag = torch.where(kept, 0.0, 1.0).to(f64)
    if bool(kept.any()):
        diag[int(torch.nonzero(kept)[0])] += scene["anchor"]
    info = torch.tensor(scene["odom_info"], dtype=f64, device=dev)
    chain = torch.zeros((t1, 3), dtype=f64, device=dev)
    chain[:-1] += info
    chain[1:] += info
    idx = torch.arange(n, device=dev)
    h[idx, idx] += (diag[:, None] + chain).reshape(-1)
    h[idx[:-3], idx[:-3] + 3] -= info.repeat(t1 - 1)
    h[idx[:-3] + 3, idx[:-3]] -= info.repeat(t1 - 1)
    chol, bad = torch.linalg.cholesky_ex(_round(h, via))
    del h
    if int(bad):  # H (rounded, for the control) is not positive definite
        return {"poses": torch.full_like(x, math.nan), "gn_iters": 0,
                "delta_sum": math.nan}

    def rhs(x):
        rel = x[ta] - x[tb]
        err = torch.stack([rel[:, 0] - rel_obs[:, 0],
                           rel[:, 1] - rel_obs[:, 1],
                           wrap(wrap(rel[:, 2]) - rel_obs[:, 2])], dim=-1)
        om_err = (omega @ err[:, :, None])[:, :, 0]
        b = torch.zeros((t1, 3), dtype=f64, device=dev)
        b.index_add_(0, tb, -om_err)
        b.index_add_(0, ta, om_err)
        e_o = x[1:] - x[:-1] - rel_odom.to(f64)
        e_o = torch.stack([e_o[:, 0], e_o[:, 1], wrap(e_o[:, 2])], -1) * info
        b[:-1] -= e_o
        b[1:] += e_o
        return _round(b.reshape(n, 1), via)

    tol, stall = scene["delta_tol"], scene["stall_ratio"]
    delta_sum = prev = math.inf
    iters = 0
    while iters < scene["max_gn_iters"]:
        if iters and not (delta_sum >= tol and (
                iters < 2 or delta_sum < stall * prev)):
            break
        dx = -torch.cholesky_solve(rhs(x), chol).reshape(t1, 3)
        x = x + dx
        x = torch.stack([x[:, 0], x[:, 1], wrap(x[:, 2])], dim=-1)
        eff = torch.stack([dx[:, 0], dx[:, 1], wrap(dx[:, 2])], dim=-1)
        prev, delta_sum = delta_sum, float((eff * eff).sum())
        iters += 1
    return {"poses": x, "gn_iters": iters, "delta_sum": delta_sum}
