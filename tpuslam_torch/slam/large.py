"""Large-scale graph SLAM: windowed edges, banded information matrix,
and its solvers (PCG, the super-block Thomas chain, cyclic reduction and
the banded Cholesky), 10k+ poses.

Port of ``tpuslam/slam/large.py``.  Sightings of one landmark pair up
only within a time window ``W``, so H is block-banded with ``W + 1``
block diagonals; it is stored flat, ``h_flat[d*9 + 3a + b, t] = H[t,
t+d][a, b]`` (upper band; symmetry gives the lower half), with the rhs
as ``(3, T1)`` rows.  The Gauss-Newton loop, the gauge anchor on the
first kept time, the identity padding of times no edge keeps and the yaw
wrapping are those of the JAX package.

Differences from the JAX package, none of them in the numbers:

* **Determinism.**  The JAX package assembles H and b with 27 + 2
  scatter-adds of every edge row.  On the card a scatter-add takes
  atomics, whose order, and so whose float sum, changes from run to run.
  Here the edge list, which does not change across GN iterations, is
  grouped once a solve by the entry of H (or b) it lands on
  (:func:`build_banded_scatter`: a stable sort, one table of edge slots
  a target, ``-1``-padded in effect); each sum is then a gather and a
  reduction along the table's rows in a fixed order, placed by a plain
  indexed assignment (every target is written once).  Two runs on the
  card give the same bits.  Building the tables reads two counts from
  the device: one host synchronisation a solve.
* **The GN loop** is a Python loop that reads its condition (``delta_sum``
  against the tolerance and the stall check) once an iteration: at most
  ``max_gn_iters`` synchronisations.  The Thomas chain and the PCG loop
  inside it read nothing (PCG: its condition every
  :data:`~tpuslam_torch.core.pcg.CHECK_EVERY` iterations).
* **Solvers.**  ``"cg"``, ``"tridiag"`` (with ``n_parts``, the
  partitioned factor), ``"cr"`` and ``"cholesky"``, as in the JAX
  package; an unknown solver name raises ``ValueError`` (the JAX package
  runs CG for any name it does not know).
* **RNG at the module edge.**  :func:`make_large_scene` draws from a
  ``torch.Generator``; :func:`make_large_scene_with_noise` takes the
  draws.
* **A scene axis** (the JAX package's users ``vmap``): the factor-reuse
  path of :func:`graph_solve_banded` takes ``S`` scenes at once, poses
  ``(S, T1, 3)``, observations ``(S, T1, L)`` and edge lists ``(S, E)``.
  The edge work runs on the scenes laid end to end, scene s's times
  offset by ``s * T1`` (one grouping, one host read for all of them);
  the banded H is ``(S, (band+1)*9, T1)`` and the Thomas chain steps
  once over the super-blocks, batched over the scenes.  The GN loop is
  the dense solver's lockstep (``slam/graph.py::graph_solve``): each pass
  runs every scene, only the active ones take its update, each keeps its
  own stop rule, and one host read a pass asks whether any is active.

Spans (``utils/profiling.py::span``): ``tpuslam.graph_large.solve``
around a solve, inside it ``.scatter`` (the edge grouping), ``.terms``
(edge terms and the constant H), ``.factor``, ``.pass`` (one GN pass:
rhs, solve, update) and ``.cond`` (the host read of the GN condition).
Counters: :data:`sync_count`, the host reads of this module (the
grouping's and the GN condition's; PCG's own reads are not counted),
:data:`sync_wait_s`, the host seconds spent in them (waiting for the
device to reach them), and :data:`gn_passes`, the GN passes run (a
lockstep pass counts once).

The reference's own quirk is kept: the delta is masked by a multiply,
``delta * kept[:, None]``, so a NaN in a time no edge keeps survives as
it does there.
"""

from __future__ import annotations

import math
import time
import typing

import numpy as np
import torch
import torch.nn.functional as F

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.core.pcg import pcg
from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.core.se2 import BASE_ANG
from tpuslam_torch.slam.cholesky import banded_solve_direct_flat
from tpuslam_torch.slam.cyclic import banded_solve_cr_flat
from tpuslam_torch.slam.graph import (GraphConfig, GraphObservations,
                                      _inv3x3, _measurement_cov_world)
from tpuslam_torch.slam.tridiag import (banded_factor_tridiag_flat,
                                        banded_resolve_tridiag_flat,
                                        banded_solve_tridiag_flat,
                                        factor_resolver)
from tpuslam_torch.utils.profiling import span

#: Host reads of the device in this module: one a grouping
#: (:func:`build_banded_scatter`) and one a GN condition.
sync_count = 0
#: Host seconds spent in those reads.
sync_wait_s = 0.0
#: GN passes run; a lockstep pass over S scenes counts once.
gn_passes = 0


def _host_read(x):
    """``x.tolist()``: a host read of the device, counted in
    :data:`sync_count` and timed in :data:`sync_wait_s`."""
    global sync_count, sync_wait_s
    t0 = time.perf_counter()
    out = x.tolist()
    sync_wait_s += time.perf_counter() - t0
    sync_count += 1
    return out


class EdgeList(typing.NamedTuple):
    """Explicit constraint index tensors; all fields ``(E,)`` (int64, and
    bool ``valid``), or ``(S, E)`` for S scenes.

    ``t_b < t_a`` (before/after times), ``lm`` the landmark index, and
    ``valid`` a mask for padding slots.
    """

    t_b: torch.Tensor
    t_a: torch.Tensor
    lm: torch.Tensor
    valid: torch.Tensor


def _end_to_end(edges: EdgeList, t1: int) -> EdgeList:
    """``(S, E)`` edge lists as one ``(S * E,)`` list over the scenes'
    ``S * T1`` times laid end to end (scene s's offset by ``s * T1``); a
    list without a scene axis as it is."""
    if edges.t_b.ndim == 1:
        return edges
    off = t1 * torch.arange(edges.t_b.shape[0],
                            device=edges.t_b.device)[:, None]
    return EdgeList(t_b=(edges.t_b + off).reshape(-1),
                    t_a=(edges.t_a + off).reshape(-1),
                    lm=edges.lm.reshape(-1), valid=edges.valid.reshape(-1))


def _rows_end_to_end(x):
    """``(S, T1, ...)`` per-time rows (poses, observations) as ``(S * T1,
    ...)``; ``(T1, ...)`` as they are."""
    return x.reshape(-1, *x.shape[2:]) if x.ndim == 3 else x


def _host_valid(valid) -> np.ndarray:
    if isinstance(valid, torch.Tensor):
        return valid.detach().cpu().numpy()
    return np.asarray(valid)


def window_pairs(valid, window: int, max_pairs_per_lm: int | None = None,
                 *, device: torch.device | str | None = None) -> EdgeList:
    """Host-side edge-list construction from a visibility matrix.

    For each landmark, every pair of sighting times ``(t_b, t_a)`` with
    ``t_a - t_b <= window`` becomes a constraint, in the JAX package's
    order: by k, the number of sightings of the landmark between the two,
    then by landmark and time.

    Args:
        valid: ``(T1, L)`` boolean visibility, a tensor or a numpy array;
            the list is built with numpy.
        window: max time separation of a pair (in steps).
        max_pairs_per_lm: keep at most this many pairs a landmark, the
            shortest lags first.
        device: where the list goes; defaults to ``valid``'s device, and
            is required for a numpy ``valid``.

    Returns:
        :class:`EdgeList` on ``device``.
    """
    if device is None:
        if not isinstance(valid, torch.Tensor):
            raise ValueError("window_pairs: pass device= with a numpy "
                             "visibility matrix")
        device = valid.device
    valid = _host_valid(valid)
    num_l = valid.shape[1]
    # All sightings sorted by (landmark, time); for each lag k, sighting
    # i pairs with sighting i+k when both belong to the same landmark
    # and lie within the window.
    tt, ll = np.nonzero(valid)
    order = np.lexsort((tt, ll))
    tt, ll = tt[order], ll[order]
    s = len(tt)
    counts = np.bincount(ll, minlength=num_l)
    k_max = int(counts.max()) if s else 0

    t_bs, t_as, lms = [], [], []
    for k in range(1, k_max + 1):
        same_lm = ll[:-k] == ll[k:] if k < s else np.zeros(0, bool)
        in_win = (tt[k:] - tt[:-k]) <= window if k < s else same_lm
        sel = same_lm & in_win
        t_bs.append(tt[:-k][sel])
        t_as.append(tt[k:][sel])
        lms.append(ll[:-k][sel])
    t_b = np.concatenate(t_bs) if t_bs else np.zeros(0, np.int64)
    t_a = np.concatenate(t_as) if t_as else np.zeros(0, np.int64)
    lm = np.concatenate(lms) if lms else np.zeros(0, np.int64)

    if max_pairs_per_lm is not None:
        order = np.lexsort((t_a - t_b, lm))
        t_b, t_a, lm = t_b[order], t_a[order], lm[order]
        rank = np.zeros(len(lm), np.int64)
        if len(lm):
            first = np.r_[True, lm[1:] != lm[:-1]]
            idx = np.arange(len(lm))
            start = np.maximum.accumulate(np.where(first, idx, 0))
            rank = idx - start
        keep = rank < max_pairs_per_lm
        t_b, t_a, lm = t_b[keep], t_a[keep], lm[keep]

    def t(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    return EdgeList(t_b=t(t_b), t_a=t(t_a), lm=t(lm),
                    valid=torch.ones(len(t_b), dtype=torch.bool,
                                     device=device))


def count_window_pairs(valid, window: int) -> int:
    """Exact edge count of :func:`window_pairs` (host numpy; for sizing
    the ``max_edges`` of :func:`window_pairs_device`)."""
    valid = _host_valid(valid)
    total = 0
    for d in range(1, min(window, valid.shape[0] - 1) + 1):
        total += int(np.sum(valid[:-d] & valid[d:]))
    return total


def window_pairs_device(valid, window: int, max_edges: int):
    """:func:`window_pairs` on the device of ``valid`` (the same edge SET;
    the order is by lag, then time, then landmark).

    Each lag's candidates get consecutive slots from a running offset and
    a cumulative sum, so every candidate has a slot of its own and the
    write is a plain indexed assignment.  Candidates past ``max_edges``
    go to one extra slot that is dropped (the JAX package's
    ``mode="drop"``).  Nothing is read back to the host.

    Returns:
        ``(EdgeList, n_edges)``: ``(max_edges,)`` tensors with a validity
        mask, and the true edge count as a 0-dim tensor; if ``n_edges >
        max_edges`` the list is truncated.
    """
    t1, num_l = valid.shape
    dev = valid.device
    out_tb = torch.zeros(max_edges + 1, dtype=torch.int64, device=dev)
    out_ta = torch.zeros_like(out_tb)
    out_lm = torch.zeros_like(out_tb)
    out_valid = torch.zeros(max_edges + 1, dtype=torch.bool, device=dev)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    tt = torch.arange(t1, device=dev)[:, None]
    lml = torch.arange(num_l, device=dev)[None, :]
    for d in range(1, min(window, t1 - 1) + 1):
        m = (valid[:-d] & valid[d:]).reshape(-1)
        pos = offset + torch.cumsum(m, 0) - 1
        idx = torch.where(m & (pos < max_edges), pos, max_edges)
        tb = tt[:t1 - d].expand(t1 - d, num_l).reshape(-1)
        out_tb[idx] = tb
        out_ta[idx] = tb + d
        out_lm[idx] = lml.expand(t1 - d, num_l).reshape(-1)
        out_valid[idx] = True
        offset = offset + m.sum()
    return EdgeList(t_b=out_tb[:max_edges], t_a=out_ta[:max_edges],
                    lm=out_lm[:max_edges],
                    valid=out_valid[:max_edges]), offset


class BandedScatter(typing.NamedTuple):
    """Where the edge terms land, grouped by target (see
    :func:`build_banded_scatter`).

    Block entries are the ``3E`` rows ``[h_bb; h_aa; h_ba]`` (targets
    ``(0, t_b)``, ``(0, t_a)`` and ``(t_a - t_b, t_b)`` as ``(d, t)``);
    column entries the ``2E`` rows ``[b_b; b_a]`` (targets ``t_b``,
    ``t_a``).  A table row lists one target's entries in entry order,
    padded with the index one past the last entry (a zero row).
    """

    blk_table: torch.Tensor  # (P, deg) int64
    blk_d: torch.Tensor  # (P,) band offset of each target block
    blk_t: torch.Tensor  # (P,) its column
    col_table: torch.Tensor  # (Q, deg') int64
    col_t: torch.Tensor  # (Q,) each target column


def _group_keys(keys, drop, sentinel: int):
    """Stable sort of ``keys`` with the dropped ones last: ``(sorted keys,
    order, group id, rank in group, live, groups, largest group)``, the
    last two as 0-dim tensors."""
    dev = keys.device
    ks, order = torch.sort(torch.where(drop, sentinel, keys), stable=True)
    n = ks.shape[0]
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = ks[1:] != ks[:-1]
    gid = torch.cumsum(first, 0) - 1
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    live = ks != sentinel
    n_groups = (first & live).sum()
    deg = torch.where(live, rank, -1).max() + 1
    return ks, order, gid, rank, live, n_groups, deg


def _group_table(grouped, n_groups: int, deg: int, pad: int):
    """``(table (n_groups, deg), key of each group)`` from
    :func:`_group_keys`'s output, now that the host knows the sizes."""
    ks, order, gid, rank, live = grouped[:5]
    dev = ks.device
    g = torch.where(live, gid, n_groups)  # dropped entries: a spare row
    r = torch.where(live, rank, 0)
    table = torch.full((n_groups + 1, max(deg, 1)), pad, dtype=torch.int64,
                       device=dev)
    table[g, r] = order
    key = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    key[g] = ks  # every entry of a group writes the same key
    return table[:n_groups], key[:n_groups]


def build_banded_scatter(edges: EdgeList, t1: int,
                         band: int | None = None) -> BandedScatter:
    """Group the edge list by the entries of H and b it lands on, once
    per solve (the edge list does not change across GN iterations).

    Targets follow the JAX package's scatters (``large.py:398-410``):
    ``h_bb`` at block ``(0, t_b)``, ``h_aa`` at ``(0, t_a)``, ``h_ba`` at
    ``(t_a - t_b, t_b)``, ``b_b`` at ``t_b`` and ``b_a`` at ``t_a``.
    Padding slots (``valid`` False) carry masked, zero terms and are
    left out, as are ``h_ba`` terms with ``t_a - t_b`` outside ``[0,
    band]`` (the JAX package's out-of-range scatter drops them).  With
    ``band=None`` only the column table is built (``blk_*`` empty).

    With ``(S, E)`` edge lists the targets are those of the scenes laid
    end to end (``t1 * S`` times, scene s's offset by ``s * T1``): one
    grouping for all of them.

    Reads the group counts and sizes back: one host synchronisation.
    """
    if edges.t_b.ndim == 2:
        edges, t1 = _end_to_end(edges, t1), edges.t_b.shape[0] * t1
    dev = edges.t_b.device
    e = edges.t_b.shape[0]
    off = ~edges.valid
    parts = [(torch.cat([edges.t_b, edges.t_a]), torch.cat([off, off]),
              t1, 2 * e)]
    if band is not None:
        d = edges.t_a - edges.t_b
        parts.append((
            torch.cat([edges.t_b, edges.t_a, d * t1 + edges.t_b]),
            torch.cat([off, off, off | (d < 0) | (d > band)]),
            (band + 1) * t1, 3 * e))
    tables = []
    if e:
        grouped = [_group_keys(keys, drop, sentinel)
                   for keys, drop, sentinel, _ in parts]
        sizes = _host_read(torch.stack([v for g in grouped
                                        for v in g[5:]]))
        for i, g in enumerate(grouped):
            tables.append(_group_table(g, sizes[2 * i], sizes[2 * i + 1],
                                       parts[i][3]))
    else:
        tables = [(torch.zeros((0, 1), dtype=torch.int64, device=dev),
                   torch.zeros(0, dtype=torch.int64, device=dev))
                  for _ in parts]
    col_table, col_t = tables[0]
    if band is None:
        blk_table, blk_key = tables[0][0][:0], col_t[:0]
    else:
        blk_table, blk_key = tables[1]
    return BandedScatter(blk_table=blk_table, blk_d=blk_key // t1,
                         blk_t=blk_key % t1, col_table=col_table,
                         col_t=col_t)


def _gather_sum(rows, table):
    """Sum of ``rows[table[i]]`` along each table row, in a fixed order
    (``rows`` gets a zero row for the padding index)."""
    rows = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])])
    return rows[table].sum(dim=1)


def _columns(scatter: BandedScatter, b_b, b_a, t1: int):
    """``(3, T1)`` rows of ``b_b`` summed at ``t_b`` and ``b_a`` at
    ``t_a``."""
    out = b_b.new_zeros((3, t1))
    out[:, scatter.col_t] = _gather_sum(torch.cat([b_b, b_a]),
                                        scatter.col_table).T
    return out


def _gather_obs(obs: GraphObservations, edges: EdgeList):
    tb, ta, lm = edges.t_b, edges.t_a, edges.lm
    return (obs.dist[tb, lm], obs.dist[ta, lm], obs.bearing[tb, lm],
            obs.bearing[ta, lm], obs.orient[tb, lm], obs.orient[ta, lm])


def _edge_omega(cfg, d_b, d_a, dir_b, dir_a, omega_poses, edges):
    cov = (_measurement_cov_world(cfg, d_a, dir_a,
                                  omega_poses[edges.t_a][:, 2])
           + _measurement_cov_world(cfg, d_b, dir_b,
                                    omega_poses[edges.t_b][:, 2]))
    return _inv3x3(cov)


@highest_matmul_precision
def build_edge_blocks(cfg: GraphConfig, poses, obs: GraphObservations,
                      edges: EdgeList, omega_poses=None):
    """Per-edge premultiplied blocks, gathered by index tensors (the
    dense path's ``build_edges`` math over an explicit ``(E,)`` edge
    list, graph_based_slam.py:362-439).

    Args:
        omega_poses: poses that rotate the measurement covariances into
            the world frame (defaults to ``poses``); passing the initial
            guess freezes the information across GN iterations.

    Returns a dict of ``(E, ...)`` tensors: h_bb, h_ba, h_aa, b_b, b_a,
    mask (h_ab = h_ba^T).
    """
    if omega_poses is None:
        omega_poses = poses
    tb, ta, lm = edges.t_b, edges.t_a, edges.lm
    d_b, d_a, dir_b, dir_a, or_b, or_a = _gather_obs(obs, edges)
    mask = obs.valid[tb, lm] & obs.valid[ta, lm] & edges.valid

    pose_b = poses[tb]
    pose_a = poses[ta]
    rel = pose_a - pose_b
    dwb = wrap_angle(math.pi + dir_b - or_b)
    dwa = wrap_angle(math.pi + dir_a - or_a)
    owb = wrap_angle(BASE_ANG - or_b)
    owa = wrap_angle(BASE_ANG - or_a)
    err = torch.stack([
        rel[:, 0] - (d_a * torch.cos(dwa) - d_b * torch.cos(dwb)),
        rel[:, 1] - (d_a * torch.sin(dwa) - d_b * torch.sin(dwb)),
        wrap_angle(wrap_angle(rel[:, 2]) - wrap_angle(owa - owb)),
    ], dim=-1)  # (E, 3)
    omega = _edge_omega(cfg, d_b, d_a, dir_b, dir_a, omega_poses, edges)

    m = mask.to(poses.dtype)[:, None, None]
    if cfg.exact_jacobians:
        # err = (pose_a - pose_b) - rel_obs is linear in the poses:
        # J_a = I, J_b = -I, and the blocks are +/-Omega.
        om = omega * m
        om_err = torch.einsum("eij,ej->ei", om, err)
        return {"h_bb": om, "h_ba": -om, "h_aa": om, "b_b": -om_err,
                "b_a": om_err, "mask": mask}

    th_b = wrap_angle(pose_b[:, 2] + dir_b)
    th_a = wrap_angle(pose_a[:, 2] + dir_a)
    zero = torch.zeros_like(d_b)
    one = torch.ones_like(d_b)

    def _jac(sign, d, th):
        return torch.stack([
            torch.stack([sign * one, zero, -sign * d * torch.sin(th)], -1),
            torch.stack([zero, sign * one, sign * d * torch.cos(th)], -1),
            torch.stack([zero, zero, sign * one], -1),
        ], dim=-2)

    j_b = _jac(-1.0, d_b, th_b)
    j_a = _jac(1.0, d_a, th_a)
    jt_om_b = torch.einsum("eji,ejk->eik", j_b, omega)
    jt_om_a = torch.einsum("eji,ejk->eik", j_a, omega)
    return {
        "h_bb": torch.einsum("eij,ejk->eik", jt_om_b, j_b) * m,
        "h_ba": torch.einsum("eij,ejk->eik", jt_om_b, j_a) * m,
        "h_aa": torch.einsum("eij,ejk->eik", jt_om_a, j_a) * m,
        "b_b": torch.einsum("eij,ej->ei", jt_om_b, err) * m[..., 0],
        "b_a": torch.einsum("eij,ej->ei", jt_om_a, err) * m[..., 0],
        "mask": mask,
    }


@highest_matmul_precision
def exact_edge_terms(cfg: GraphConfig, obs: GraphObservations,
                     edges: EdgeList, omega_poses):
    """Constant per-edge terms of the exact-linear formulation (the same
    expressions as :func:`build_edge_blocks`, so :func:`exact_rhs_flat`
    rebuilds the rhs bit for bit): ``(om (E, 3, 3) mask-premultiplied,
    rel_obs (E, 3), mask (E,))``, each with the edge list's scene axis
    where it has one (``obs`` ``(S, T1, L)``, ``omega_poses`` ``(S, T1,
    3)``)."""
    scenes = edges.t_b.shape[:-1]
    t1 = omega_poses.shape[-2]
    obs = GraphObservations(*map(_rows_end_to_end, obs))
    edges = _end_to_end(edges, t1)
    omega_poses = _rows_end_to_end(omega_poses)
    tb, ta, lm = edges.t_b, edges.t_a, edges.lm
    d_b, d_a, dir_b, dir_a, or_b, or_a = _gather_obs(obs, edges)
    mask = obs.valid[tb, lm] & obs.valid[ta, lm] & edges.valid
    dwb = wrap_angle(math.pi + dir_b - or_b)
    dwa = wrap_angle(math.pi + dir_a - or_a)
    owb = wrap_angle(BASE_ANG - or_b)
    owa = wrap_angle(BASE_ANG - or_a)
    rel_obs = torch.stack([
        d_a * torch.cos(dwa) - d_b * torch.cos(dwb),
        d_a * torch.sin(dwa) - d_b * torch.sin(dwb),
        wrap_angle(owa - owb),
    ], dim=-1)
    om = (_edge_omega(cfg, d_b, d_a, dir_b, dir_a, omega_poses, edges)
          * mask.to(omega_poses.dtype)[:, None, None])
    return (om.reshape(*scenes, -1, 3, 3), rel_obs.reshape(*scenes, -1, 3),
            mask.reshape(*scenes, -1))


@highest_matmul_precision
def exact_edge_omega(cfg: GraphConfig, obs: GraphObservations,
                     edges: EdgeList, omega_poses, mask):
    """Only the per-edge information blocks ``om`` from new
    linearization poses (the Omega half of :func:`exact_edge_terms`)."""
    d_b, d_a, dir_b, dir_a, _, _ = _gather_obs(obs, edges)
    return (_edge_omega(cfg, d_b, d_a, dir_b, dir_a, omega_poses, edges)
            * mask.to(omega_poses.dtype)[:, None, None])


@highest_matmul_precision
def exact_rhs_flat(poses, om, rel_obs, edges: EdgeList, t1: int, *,
                   scatter: BandedScatter | None = None):
    """Rebuild only the rhs ``b_flat (3, T1)`` from the current poses
    with the frozen ``om`` (the b half of :func:`build_edge_blocks` +
    :func:`assemble_banded_flat`, bit for bit).  ``scatter`` is
    :func:`build_banded_scatter`'s (built here if not given).  With a
    scene axis (poses ``(S, T1, 3)``, edges ``(S, E)``, ``om`` ``(S, E,
    3, 3)``, ``rel_obs`` ``(S, E, 3)``) the rhs is ``(S, 3, T1)``."""
    if scatter is None:
        scatter = build_banded_scatter(edges, t1)
    scenes = poses.shape[:-2]
    edges = _end_to_end(edges, t1)
    poses = _rows_end_to_end(poses)
    om, rel_obs = om.reshape(-1, 3, 3), rel_obs.reshape(-1, 3)
    rel = poses[edges.t_a] - poses[edges.t_b]
    err = torch.stack([
        rel[:, 0] - rel_obs[:, 0],
        rel[:, 1] - rel_obs[:, 1],
        wrap_angle(wrap_angle(rel[:, 2]) - rel_obs[:, 2]),
    ], dim=-1)
    om_err = torch.einsum("eij,ej->ei", om, err)
    if not scenes:
        return _columns(scatter, -om_err, om_err, t1)
    n_s = scenes[0]
    return _columns(scatter, -om_err, om_err, n_s * t1).reshape(
        3, n_s, t1).transpose(0, 1)


def assemble_banded_flat(cfg: GraphConfig, blocks, edges: EdgeList,
                         t1: int, band: int, *,
                         scatter: BandedScatter | None = None):
    """Sum the edge blocks into flat banded storage: ``h_flat[d*9 + 3a +
    b, i]`` holds ``H[i, i+d][a, b]`` (d in [0, band]), ``b_flat[a, i]``
    the rhs.  Each target is summed in a fixed order and written once
    (see :func:`build_banded_scatter`, built here if not given).

    Returns ``(h_flat ((band+1)*9, T1), b_flat (3, T1), kept (T1,))``,
    each with a leading ``(S,)`` for ``(S, E)`` edge lists (the blocks
    then ``(S, E, ...)``): every scene its own padding and anchor.
    """
    if scatter is None:
        scatter = build_banded_scatter(edges, t1, band)
    scenes = edges.t_b.shape[:-1]
    n_s = scenes[0] if scenes else 1
    t_all = n_s * t1
    dtype = blocks["h_bb"].dtype
    entries = torch.cat([blocks[k].reshape(-1, 9)
                         for k in ("h_bb", "h_aa", "h_ba")])
    h3 = torch.zeros((band + 1, 9, t_all), dtype=dtype,
                     device=entries.device)
    h3[scatter.blk_d, :, scatter.blk_t] = _gather_sum(entries,
                                                      scatter.blk_table)
    b_flat = _columns(scatter, blocks["b_b"].reshape(-1, 3),
                      blocks["b_a"].reshape(-1, 3), t_all)

    m = blocks["mask"].reshape(-1)
    kept = torch.zeros(t_all, dtype=torch.bool, device=m.device)
    hit = torch.cat([m, m, m.new_zeros(1)])[scatter.col_table]
    kept[scatter.col_t] = hit.any(dim=1)
    if scenes:
        h3 = h3.reshape(band + 1, 9, n_s, t1).movedim(2, 0)
        b_flat = b_flat.reshape(3, n_s, t1).transpose(0, 1)
        kept = kept.reshape(n_s, t1)

    # Identity padding for unconstrained times (delta stays exactly 0)
    # + gauge anchor on the first kept block (graph_based_slam.py:474-475).
    first_kept = kept.to(torch.int32).argmax(dim=-1, keepdim=True)
    on_first = torch.arange(t1, device=m.device) == first_kept
    anchor = torch.where(on_first & kept.any(dim=-1, keepdim=True),
                         cfg.anchor, 0.0).to(dtype)
    pad = torch.where(kept, 0.0, 1.0).to(dtype)
    for k in (0, 4, 8):
        h3[..., 0, k, :] += pad
        h3[..., 0, k, :] += anchor
    return h3.reshape(*scenes, (band + 1) * 9, t1), b_flat, kept


def assemble_banded(cfg: GraphConfig, blocks, edges: EdgeList, t1: int,
                    band: int, *, scatter: BandedScatter | None = None):
    """Block-banded storage: ``h_band[d, i]`` holds block ``H[i, i+d]``.

    Returns ``(h_band (band+1, T1, 3, 3), b (T1, 3), kept (T1,))``.
    """
    h_flat, b_flat, kept = assemble_banded_flat(cfg, blocks, edges, t1,
                                                band, scatter=scatter)
    h_band = h_flat.reshape(band + 1, 9, t1).transpose(1, 2).reshape(
        band + 1, t1, 3, 3)
    return h_band, b_flat.T, kept


def _odometry_err(poses, rel_odom, odom_info):
    """``Omega err`` rows ``(3, T1-1)`` of the odometry chain, the
    diagonal information as three scalars (``(S, 3, T1-1)`` for ``(S, T1,
    3)`` poses)."""
    err = poses[..., 1:, :] - poses[..., :-1, :] - rel_odom
    return torch.stack([err[..., 0] * float(odom_info[0]),
                        err[..., 1] * float(odom_info[1]),
                        wrap_angle(err[..., 2]) * float(odom_info[2])],
                       dim=-2)


def odometry_rhs_flat(b_flat, poses, rel_odom, odom_info):
    """The rhs half of :func:`add_odometry_chain_flat` (the chain's H
    contribution is pose-independent; the factor-reuse GN loop rebuilds
    only this each iteration).  Each scene of a leading axis has its own
    chain."""
    w_err = _odometry_err(poses, rel_odom, odom_info)
    b_flat = b_flat.clone()
    b_flat[..., :-1] -= w_err
    b_flat[..., 1:] += w_err
    return b_flat


def add_odometry_chain_flat(h_flat, b_flat, poses, rel_odom, odom_info):
    """Flat-layout twin of :func:`add_odometry_chain` (row slice-adds),
    a chain for each scene of a leading axis."""
    h_flat = h_flat.clone()
    for r in range(3):
        k = 4 * r  # diagonal entry (r, r)
        info = float(odom_info[r])
        h_flat[..., k, :-1] += info
        h_flat[..., k, 1:] += info
        h_flat[..., 9 + k, :-1] -= info
    return h_flat, odometry_rhs_flat(b_flat, poses, rel_odom, odom_info)


def add_odometry_chain(h_band, bvec, poses, rel_odom, odom_info):
    """Add consecutive-pose odometry constraints to the banded system.

    Residual ``(pose[t+1] - pose[t]) - rel_odom[t]`` (yaw wrapped),
    linear in the poses, with diagonal information ``odom_info``:
    blocks ``+/-Omega``.

    Args:
        rel_odom: ``(T1-1, 3)`` measured odometry deltas.
        odom_info: ``(3,)`` information diagonal (1/sigma^2 per axis).

    Returns:
        Updated ``(h_band, bvec)``.
    """
    omega = h_band.new_zeros((3, 3))
    for r in range(3):
        omega[r, r] = float(odom_info[r])
    w_err = _odometry_err(poses, rel_odom, odom_info).T
    h_band = h_band.clone()
    h_band[0, :-1] += omega
    h_band[0, 1:] += omega
    h_band[1, :-1] -= omega
    bvec = bvec.clone()
    bvec[:-1] -= w_err
    bvec[1:] += w_err
    return h_band, bvec


def make_banded_matvec(h_band):
    """``x -> H x`` for block-banded upper storage ``(D, T1, 3, 3)``: the
    masked upper band and the shifted, transposed lower band are built
    once, so each product is two batched einsums."""
    d1, t1 = h_band.shape[0], h_band.shape[1]
    dev = h_band.device
    offs = torch.arange(d1, device=dev)[:, None]
    rows = torch.arange(t1, device=dev)[None, :]
    # Upper: y[i] += sum_d H[d, i] @ x[i + d]   (while i + d < T1)
    idx_u = rows + offs
    valid_u = (idx_u < t1)[..., None]
    idx_u = idx_u.clamp(0, t1 - 1)
    h_up = h_band * valid_u[..., None]
    # Lower: y[j] += sum_{d>=1} H[d, j - d]^T @ x[j - d]
    idx_l = rows - offs
    valid_l = ((idx_l >= 0) & (offs >= 1))[..., None]
    idx_l = idx_l.clamp(0, t1 - 1)
    h_low = h_band[offs, idx_l].mT * valid_l[..., None]

    def matvec(x):
        xu = x[idx_u] * valid_u
        xl = x[idx_l] * valid_l
        return (torch.einsum("dtij,dtj->ti", h_up, xu)
                + torch.einsum("dtij,dtj->ti", h_low, xl))

    return matvec


@highest_matmul_precision
def banded_matvec(h_band, x):
    """y = H x with block-banded upper storage + symmetry (one-shot; in
    iterative solvers build :func:`make_banded_matvec` once)."""
    return make_banded_matvec(h_band)(x)


def _dot(a, c):
    return torch.sum(a * c)


@highest_matmul_precision
def cg_solve(h_band, b, max_iters: int = 200, tol: float = 1e-8):
    """Block-Jacobi-preconditioned conjugate gradients on banded H
    (matrix-free, through the shared
    :func:`~tpuslam_torch.core.pcg.pcg`).  Returns ``(x (T1, 3),
    iters)``."""
    minv = _inv3x3(h_band[0])  # (T1, 3, 3) block-Jacobi preconditioner
    matvec = make_banded_matvec(h_band)

    def precond(r):
        return torch.einsum("tij,tj->ti", minv, r)

    return pcg(matvec, precond, _dot, b, max_iters, tol)


def make_banded_matvec_flat(h_flat, band: int):
    """Flat-layout twin of :func:`make_banded_matvec`: ``x -> H x`` with
    ``x`` and the result as ``(3, T1)`` rows.

    Upper term: ``y[a, t] += sum_{d, b} H[t, t+d][a, b] x[b, t+d]``, ``x``
    shifted by slices of a zero-padded copy (the JAX package's pads).
    Lower term: ``y[b, j] += sum_{d>=1, a} H[j-d, j][a, b] x[a, j-d]``,
    the JAX package's products shifted right by d; here each band row is
    shifted once when the closure is built, and ``x`` by slices.  Each
    3-term sum runs in the JAX package's order; the sum over d is one
    reduction.
    """
    d1 = band + 1
    t1 = h_flat.shape[1]
    h = h_flat.reshape(d1, 3, 3, t1)  # [d, a, b, t] = H[t, t+d][a, b]
    # h_low[k, a, b, j] = H[j-d, j][a, b] with d = band - k (0 for j < d)
    h_low = h.new_zeros((band, 3, 3, t1))
    for d in range(1, min(d1, t1)):
        h_low[band - d, ..., d:] = h[d, ..., :t1 - d]

    def matvec(x):
        # xu[d, b, t] = x[b, t + d]; xl[k, a, j] = x[a, j - (band - k)]
        xu = F.pad(x, (0, band)).unfold(1, t1, 1).transpose(0, 1)
        xl = F.pad(x, (band, 0)).unfold(1, t1, 1)[:, :band].transpose(0, 1)
        up = h * xu[:, None]
        low = h_low * xl[:, :, None]
        y_up = (up[:, :, 0] + up[:, :, 1] + up[:, :, 2]).sum(dim=0)
        y_low = (low[:, 0] + low[:, 1] + low[:, 2]).sum(dim=0)
        return y_up + y_low

    return matvec


def _inv3x3_flat(h9):
    """Closed-form inverse of per-lane 3x3 blocks stored as 9 scalar rows
    ``h9[(3a + b), t]``; returns the same layout (the adjugate over the
    determinant, as ``graph.py::_inv3x3``, with no guard)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = (h9[k] for k in range(9))
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    return torch.stack([c00, c01, c02, c10, c11, c12, c20, c21, c22]) / det


@highest_matmul_precision
def cg_solve_flat(h_flat, b_flat, band: int, max_iters: int = 200,
                  tol: float = 1e-8):
    """Flat-layout twin of :func:`cg_solve` (same PCG routine, same
    block-Jacobi preconditioner) on ``((band+1)*9, T1)`` / ``(3, T1)``
    storage.  Returns ``((T1, 3) solution, iterations)``."""
    minv = _inv3x3_flat(h_flat[0:9]).reshape(3, 3, -1)
    matvec = make_banded_matvec_flat(h_flat, band)

    def precond(r):
        return minv[:, 0] * r[0] + minv[:, 1] * r[1] + minv[:, 2] * r[2]

    x, iters = pcg(matvec, precond, _dot, b_flat, max_iters, tol)
    return x.T, iters


def _large_scene(cfg: GraphConfig, n_poses: int, n_landmarks: int,
                 radius: float, odom_noise: float, scan_chunk, lm_offsets,
                 lm_perm, chunk_normals, odom_normals):
    """The scene from its draws; ``odom_normals()`` gives the odometry
    normals and then ``chunk_normals(i)`` pose chunk i's scan normals,
    called in that order (so the odometry does not depend on
    ``scan_chunk``)."""
    from tpuslam_torch.models.scan_sensor import scan_apply_noise, scan_true

    if scan_chunk is not None and n_poses % scan_chunk:
        raise ValueError(f"scan_chunk {scan_chunk} must divide "
                         f"n_poses {n_poses}")
    dev, dtype = lm_offsets.device, lm_offsets.dtype
    phi = (torch.arange(n_poses, dtype=dtype, device=dev)
           * (2.0 * math.pi / n_poses))
    poses_true = torch.stack([radius * torch.cos(phi),
                              radius * torch.sin(phi),
                              wrap_angle(phi + BASE_ANG)], dim=-1)
    r_lm = radius + lm_offsets
    a_lm = lm_perm.to(dtype) * (2.0 * math.pi / n_landmarks)
    landmarks = torch.stack([r_lm * torch.cos(a_lm), r_lm * torch.sin(a_lm)],
                            dim=-1)
    drift = torch.cumsum(odom_normals() * odom_noise, dim=0)
    poses_odom = poses_true + drift
    poses_odom = torch.cat([poses_odom[:, :2],
                            wrap_angle(poses_odom[:, 2:3])], dim=1)
    chunk = n_poses if scan_chunk is None else scan_chunk
    parts = []
    for i in range(n_poses // chunk):
        true = scan_true(cfg.scan, poses_true[i * chunk:(i + 1) * chunk],
                         landmarks)
        parts.append(scan_apply_noise(cfg.scan, true, chunk_normals(i)))
    noisy = [torch.cat(f) for f in zip(*parts)]
    return poses_true, poses_odom, GraphObservations(*noisy)


def make_large_scene_with_noise(cfg: GraphConfig, n_poses: int,
                                n_landmarks: int, lm_offsets, lm_perm,
                                scan_normals, odom_normals,
                                radius: float = 200.0,
                                odom_noise: float = 0.02,
                                scan_chunk: int | None = None):
    """:func:`make_large_scene` from given draws, on their device:
    ``lm_offsets`` ``(L,)`` landmark radius offsets (uniform in [-10,
    10)), ``lm_perm`` ``(L,)`` a permutation of ``range(L)`` (the
    landmarks' angular slots), ``scan_normals`` ``(T1, L, 3)`` and
    ``odom_normals`` ``(T1, 3)`` standard normals."""
    def chunk_normals(i):
        c = n_poses if scan_chunk is None else scan_chunk
        return scan_normals[i * c:(i + 1) * c]

    return _large_scene(cfg, n_poses, n_landmarks, radius, odom_noise,
                        scan_chunk, lm_offsets, lm_perm, chunk_normals,
                        lambda: odom_normals)


def make_large_scene(cfg: GraphConfig, generator: torch.Generator,
                     n_poses: int, n_landmarks: int, radius: float = 200.0,
                     odom_noise: float = 0.02,
                     scan_chunk: int | None = None, *,
                     device: torch.device | str):
    """Synthetic large-loop scenario (the reference demo's circular
    course scaled up, graph_based_slam.py:903-907): landmarks in an
    annulus around the path, one scan of every landmark from every pose,
    and an odometry guess that is truth plus a random-walk drift.

    Draws, in this order, from ``generator`` (which must lie on
    ``device``): the landmark radius offsets, their angular permutation,
    the odometry normals, each pose chunk's scan normals (so the
    odometry is the same whatever ``scan_chunk``).

    Args:
        scan_chunk: scan the poses in chunks of this size (bounds the
            scan's ``(chunk, L, 2)`` intermediates); must divide
            ``n_poses``.

    Returns ``(poses_true, poses_odom, obs)`` with ``(T1, ...)`` /
    ``(T1, L)`` shapes (T1 = n_poses), float32.
    """
    from tpuslam_torch.filters.pf import check_generator

    device = check_generator(generator, device)
    chunk = n_poses if scan_chunk is None else scan_chunk

    def draw(shape):
        return torch.randn(shape, generator=generator, device=device)

    lm_offsets = torch.rand(n_landmarks, generator=generator,
                            device=device) * 20.0 - 10.0
    lm_perm = torch.randperm(n_landmarks, generator=generator,
                             device=device)
    return _large_scene(cfg, n_poses, n_landmarks, radius, odom_noise,
                        scan_chunk, lm_offsets, lm_perm,
                        lambda i: draw((chunk, n_landmarks, 3)),
                        lambda: draw((n_poses, 3)))


class BandedSolveResult(typing.NamedTuple):
    poses: torch.Tensor
    gn_iters: torch.Tensor
    delta_sum: torch.Tensor
    cg_iters_last: torch.Tensor


_SOLVERS = ("cg", "tridiag", "cr", "cholesky")


def _check_solver(solver: str) -> None:
    if solver not in _SOLVERS:
        raise ValueError(f"unknown solver {solver!r}: one of {_SOLVERS}")


@highest_matmul_precision
def graph_solve_banded(cfg: GraphConfig, poses_init,
                       obs: GraphObservations, edges: EdgeList, band: int,
                       cg_iters: int = 200, cg_tol: float = 1e-8,
                       rel_odom=None, odom_info=(100.0, 100.0, 400.0),
                       solver: str = "cg",
                       relinearize_omega: bool = False,
                       delta_tol: float | None = None,
                       damping: float = 0.0,
                       super_size: int | None = None,
                       stall_ratio: float | None = None,
                       reuse_factorization: bool | None = None,
                       refactor_every: int | None = None,
                       n_parts: int | None = None) -> BandedSolveResult:
    """Gauss-Newton with banded assembly and a selectable inner solver,
    on the device of ``poses_init`` (the large-scale twin of
    :func:`~tpuslam_torch.slam.graph.graph_solve`).

    Args are the JAX package's:
        rel_odom: optional ``(T1-1, 3)`` odometry deltas; adds a
            consecutive-pose motion chain with information ``odom_info``.
        solver: ``"cg"`` (block-Jacobi PCG, matrix-free),
            ``"tridiag"`` (super-block Thomas), ``"cr"`` (super-block
            cyclic reduction, :func:`~tpuslam_torch.slam.cyclic.
            banded_solve_cr_flat`) or ``"cholesky"`` (the banded 3x3
            Cholesky, :func:`~tpuslam_torch.slam.cholesky.
            banded_solve_direct_flat`); any other name ``ValueError``.
        relinearize_omega: recompute the measurement information from
            the current estimates each GN iteration (the reference's
            behaviour); default False freezes it at the initial guess.
        delta_tol: GN stop threshold on ||dx||^2 (default
            ``cfg.delta_sum_threshold``).
        damping: Levenberg term, ``damping * diag(H)`` added each
            iteration.
        super_size: super-block size for ``"tridiag"`` (default
            ``band``).
        stall_ratio: also stop once ``delta_sum > stall_ratio *
            previous delta_sum``.
        reuse_factorization: factor H once and substitute each
            iteration; valid only when H is constant (exact Jacobians,
            frozen Omega, ``"tridiag"``), and on by default there.
        refactor_every: with ``relinearize_omega=True`` (and exact
            Jacobians, ``"tridiag"``), refresh Omega and the factor only
            every k-th iteration.
        n_parts: partition the Thomas factor and substitution into
            that many chunks batched together
            (:func:`~tpuslam_torch.slam.tridiag.
            block_thomas_factor_partitioned`): chains of depth N /
            n_parts plus a reduced chain of n_parts.  The reuse path
            only (``ValueError`` otherwise); the poses agree with the
            sequential factor's to rounding.

    A scene axis (poses ``(S, T1, 3)``, observations ``(S, T1, L)``,
    edges ``(S, E)`` padded with ``valid`` False as
    :func:`window_pairs_device` pads them, ``rel_odom`` ``(S, T1-1, 3)``)
    runs S solves in lockstep on the factor-reuse path, and only there:
    the result's fields carry the leading ``(S,)``, and scene s's are
    those of its own solve, to the rounding of batched products.

    Host synchronisations: one to group the edges
    (:func:`build_banded_scatter`) and one a GN iteration, whatever S;
    with ``"cg"`` also the PCG loop's reads (one every
    :data:`~tpuslam_torch.core.pcg.CHECK_EVERY` iterations).
    """
    with span("tpuslam.graph_large.solve"):
        return _graph_solve_banded(
            cfg, poses_init, obs, edges, band, cg_iters, cg_tol, rel_odom,
            odom_info, solver, relinearize_omega, delta_tol, damping,
            super_size, stall_ratio, reuse_factorization, refactor_every,
            n_parts)


def _refuse_scenes(solver, cfg, relinearize_omega, reuse_factorization,
                   refactor_every, n_parts) -> None:
    """The scene axis runs the factor-reuse path only: each other path
    raises ``ValueError`` naming itself."""
    refused = [
        (solver != "tridiag", f"solver={solver!r}"),
        (relinearize_omega, "relinearize_omega=True"),
        (refactor_every is not None, f"refactor_every={refactor_every}"),
        (n_parts is not None, f"n_parts={n_parts}"),
        (not cfg.exact_jacobians, "exact_jacobians=False"),
        (reuse_factorization is False, "reuse_factorization=False")]
    for hit, path in refused:
        if hit:
            raise ValueError(f"graph_solve_banded: {path} takes no scene "
                             "axis; S scenes run only the factor-reuse "
                             "path (solver='tridiag', exact Jacobians, "
                             "frozen Omega)")


def _graph_solve_banded(cfg, poses_init, obs, edges, band, cg_iters, cg_tol,
                        rel_odom, odom_info, solver, relinearize_omega,
                        delta_tol, damping, super_size, stall_ratio,
                        reuse_factorization, refactor_every, n_parts):
    if damping < 0.0:
        raise ValueError(f"damping must be >= 0, got {damping}; negative "
                         "damping subtracts from diag(H) and degrades "
                         "conditioning")
    _check_solver(solver)
    if poses_init.ndim == 3:
        _refuse_scenes(solver, cfg, relinearize_omega, reuse_factorization,
                       refactor_every, n_parts)
    can_reuse = (solver == "tridiag" and cfg.exact_jacobians
                 and not relinearize_omega)
    if reuse_factorization is None:
        reuse_factorization = can_reuse
    elif reuse_factorization and not can_reuse:
        raise ValueError(
            "reuse_factorization requires constant H: exact_jacobians="
            "True, relinearize_omega=False, solver='tridiag' (got "
            f"exact_jacobians={cfg.exact_jacobians}, relinearize_omega="
            f"{relinearize_omega}, solver={solver!r})")
    if refactor_every is not None:
        if refactor_every < 1:
            raise ValueError(
                f"refactor_every must be >= 1, got {refactor_every}")
        if not (solver == "tridiag" and cfg.exact_jacobians
                and relinearize_omega):
            raise ValueError(
                "refactor_every is the relinearize_omega=True fast path: "
                "requires exact_jacobians=True, relinearize_omega=True, "
                f"solver='tridiag' (got exact_jacobians="
                f"{cfg.exact_jacobians}, relinearize_omega="
                f"{relinearize_omega}, solver={solver!r}; with frozen "
                "Omega use reuse_factorization instead)")
    tol = cfg.delta_sum_threshold if delta_tol is None else delta_tol
    if n_parts is not None and not reuse_factorization:
        raise ValueError("n_parts (partitioned Thomas) is implemented "
                         "on the reuse_factorization path only")
    if reuse_factorization:
        return _graph_solve_banded_reuse(
            cfg, poses_init, obs, edges, band, rel_odom, odom_info,
            damping, super_size, tol, stall_ratio, n_parts)
    if refactor_every is not None:
        return _graph_solve_banded_relin_reuse(
            cfg, poses_init, obs, edges, band, rel_odom, odom_info,
            damping, super_size, tol, stall_ratio, refactor_every)

    t1 = poses_init.shape[0]
    with span("tpuslam.graph_large.scatter"):
        scatter = build_banded_scatter(edges, t1, band)

    def step(poses, iters):
        omega_poses = poses if relinearize_omega else poses_init
        blocks = build_edge_blocks(cfg, poses, obs, edges,
                                   omega_poses=omega_poses)
        h_flat, b_flat, kept = assemble_banded_flat(
            cfg, blocks, edges, t1, band, scatter=scatter)
        if rel_odom is not None:
            h_flat, b_flat = add_odometry_chain_flat(
                h_flat, b_flat, poses, rel_odom, odom_info)
            kept = torch.ones_like(kept)  # the chain constrains every pose
        h_flat = _damped(h_flat, damping)
        cg_it = None
        if solver == "tridiag":
            delta = banded_solve_tridiag_flat(h_flat, -b_flat, band,
                                              super_size=super_size)
        elif solver == "cr":
            delta = banded_solve_cr_flat(h_flat, -b_flat, band)
        elif solver == "cholesky":
            delta = banded_solve_direct_flat(h_flat, -b_flat, band)
        else:
            delta, cg_it = cg_solve_flat(h_flat, -b_flat, band, cg_iters,
                                         cg_tol)
        return delta * kept[:, None], cg_it

    return _gn_loop(step, poses_init, tol, cfg.max_gn_iters, stall_ratio)


def _damped(h_flat, damping: float):
    if not damping:
        return h_flat
    h_flat = h_flat.clone()
    # The diagonal rows, without a sync.
    h_flat[..., 0:9:4, :] *= 1.0 + damping
    return h_flat


def _go(delta_sum, prev, iters, tol, stall_ratio: float | None):
    """Whether GN goes on after ``iters`` updates (a tensor of each
    scene's): the absolute threshold, and the stall check (see
    ``graph_solve_banded``'s ``stall_ratio``) once two real delta_sums
    exist."""
    go = delta_sum >= tol
    if stall_ratio is not None:
        go = go & ((iters < 2) | (delta_sum < stall_ratio * prev))
    return go


def _updated(poses, delta):
    """``(poses + delta with the yaw wrapped, delta_sum)``: ``delta_sum``
    is taken on the wrap-invariant motion (a yaw that flips
    representation across +/-pi moves by ~2 pi in raw delta but by ~0
    physically)."""
    poses = poses + delta
    poses = torch.cat([poses[..., :2], wrap_angle(poses[..., 2:3])], dim=-1)
    eff = torch.cat([delta[..., :2], wrap_angle(delta[..., 2:3])], dim=-1)
    return poses, (eff * eff).flatten(-2).sum(-1)


def _gn_loop(step, poses_init, tol, max_iters: int,
             stall_ratio: float | None) -> BandedSolveResult:
    """Gauss-Newton in lockstep over the scenes of ``poses_init`` (``(T1,
    3)``, one, or ``(S, T1, 3)``): each pass runs ``step(poses, passes) ->
    (masked delta, cg iters or None)`` on every scene, only the active
    ones take the update, and each keeps its own count, ``delta_sum`` and
    stop rule (the absolute threshold, the stall check, the cap).  After
    a pass one host read asks whether any scene is active; the cap ends
    the loop without one."""
    global gn_passes
    scenes = poses_init.shape[:-2]
    dev, dtype = poses_init.device, poses_init.dtype
    poses = poses_init
    delta_sum = prev = torch.full(scenes, math.inf, dtype=dtype, device=dev)
    iters = torch.zeros(scenes, dtype=torch.int32, device=dev)
    cg_it = torch.zeros(scenes, dtype=torch.int32, device=dev)
    active = torch.full(scenes, math.inf >= tol, device=dev)
    passes = 0
    go = passes < max_iters and math.inf >= tol
    while go:
        with span("tpuslam.graph_large.pass"):
            delta, step_cg = step(poses, passes)
            cg_it = cg_it if step_cg is None else step_cg
            new_poses, new_sum = _updated(poses, delta)
            poses = torch.where(active[..., None, None], new_poses, poses)
            prev = torch.where(active, delta_sum, prev)
            delta_sum = torch.where(active, new_sum, delta_sum)
            iters = iters + active.to(torch.int32)
            active = active & _go(delta_sum, prev, iters, tol, stall_ratio)
        passes += 1
        gn_passes += 1
        go = passes < max_iters
        if go:
            with span("tpuslam.graph_large.cond"):
                go = _host_read(active.any())
    return BandedSolveResult(poses=poses, gn_iters=iters,
                             delta_sum=delta_sum, cg_iters_last=cg_it)


def _constant_h(cfg, poses, om, mask, edges, t1, band, rel_odom,
                odom_info, damping, scatter):
    """H of the exact formulation for frozen ``om`` (blocks +/-om), the
    odometry chain's H and the damping: ``(h_flat, kept)``, each with the
    scene axis of ``om`` ``(S, E, 3, 3)`` where it has one."""
    zeros_b = om.new_zeros(om.shape[:-1])
    blocks = {"h_bb": om, "h_ba": -om, "h_aa": om, "b_b": zeros_b,
              "b_a": zeros_b, "mask": mask}
    h_flat, _, kept = assemble_banded_flat(cfg, blocks, edges, t1, band,
                                           scatter=scatter)
    if rel_odom is not None:
        h_flat, _ = add_odometry_chain_flat(
            h_flat, h_flat.new_zeros((*h_flat.shape[:-2], 3, t1)), poses,
            rel_odom, odom_info)
        kept = torch.ones_like(kept)
    return _damped(h_flat, damping), kept


def _rhs(poses, om, rel_obs, edges, t1, rel_odom, odom_info, scatter):
    b_flat = exact_rhs_flat(poses, om, rel_obs, edges, t1, scatter=scatter)
    if rel_odom is not None:
        b_flat = odometry_rhs_flat(b_flat, poses, rel_odom, odom_info)
    return b_flat


def _graph_solve_banded_reuse(cfg: GraphConfig, poses_init,
                              obs: GraphObservations, edges: EdgeList,
                              band: int, rel_odom, odom_info,
                              damping: float, super_size: int | None,
                              tol, stall_ratio: float | None,
                              n_parts: int | None):
    """Factor-reuse GN, the constant-H fast path of
    :func:`graph_solve_banded`: H is assembled and Thomas-factored once
    (in ``n_parts`` chunks where given); each iteration rebuilds only
    the rhs and substitutes.  The same values as the one-shot path,
    which factors the same H each iteration.  With a scene axis every
    stage runs once for all S scenes and the GN loop is the lockstep
    one."""
    t1 = poses_init.shape[-2]
    ss = max(band, 1) if super_size is None else super_size
    with span("tpuslam.graph_large.scatter"):
        scatter = build_banded_scatter(edges, t1, band)
    with span("tpuslam.graph_large.terms"):
        om, rel_obs, mask = exact_edge_terms(cfg, obs, edges, poses_init)
        h_flat, kept = _constant_h(cfg, poses_init, om, mask, edges, t1,
                                   band, rel_odom, odom_info, damping,
                                   scatter)
    with span("tpuslam.graph_large.factor"):
        resolve = factor_resolver(h_flat, band, ss, n_parts=n_parts)

    def step(poses, passes):
        b_flat = _rhs(poses, om, rel_obs, edges, t1, rel_odom, odom_info,
                      scatter)
        return resolve(-b_flat) * kept[..., None], None

    return _gn_loop(step, poses_init, tol, cfg.max_gn_iters, stall_ratio)


def _graph_solve_banded_relin_reuse(cfg: GraphConfig, poses_init,
                                    obs: GraphObservations,
                                    edges: EdgeList, band: int, rel_odom,
                                    odom_info, damping: float,
                                    super_size: int | None, tol,
                                    stall_ratio: float | None,
                                    refactor_every: int):
    """Refactor-every-k GN for the reference's relinearization
    (graph_based_slam.py:411-417): ``om = Omega(poses)`` and the factor
    are refreshed only when ``iters % refactor_every == 0`` (decided on
    the host from the iteration count); between refreshes each
    iteration is the frozen path's rhs rebuild and substitution against
    the stale factor and ``om``.  ``refactor_every=1`` is full
    relinearization."""
    t1 = poses_init.shape[0]
    ss = max(band, 1) if super_size is None else super_size
    with span("tpuslam.graph_large.scatter"):
        scatter = build_banded_scatter(edges, t1, band)
    # rel_obs and mask are pose-independent; only om refreshes.
    om0, rel_obs, mask = exact_edge_terms(cfg, obs, edges, poses_init)

    def factor_at(om, poses):
        h_flat, kept = _constant_h(cfg, poses, om, mask, edges, t1, band,
                                   rel_odom, odom_info, damping, scatter)
        return banded_factor_tridiag_flat(h_flat, band, ss), kept

    fac0, kept = factor_at(om0, poses_init)
    state = {"om": om0, "fac": fac0}

    def step(poses, iters):
        if iters > 0 and iters % refactor_every == 0:
            state["om"] = exact_edge_omega(cfg, obs, edges, poses, mask)
            state["fac"], _ = factor_at(state["om"], poses)
        b_flat = _rhs(poses, state["om"], rel_obs, edges, t1, rel_odom,
                      odom_info, scatter)
        delta = banded_resolve_tridiag_flat(state["fac"], -b_flat, ss)
        return delta * kept[:, None], None

    return _gn_loop(step, poses_init, tol, cfg.max_gn_iters, stall_ratio)
