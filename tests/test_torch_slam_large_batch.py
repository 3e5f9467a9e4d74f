"""The large solve's scene axis (``slam/large.py``, ``slam/tridiag.py``):
S scenes in lockstep on the factor-reuse path, at ``TestBenchConfig``'s
shape (200 poses, 20 landmarks, window 30, ``bench_graph_large``'s
settings) for S = 3.

Tolerances: each scene of a batched float32 solve against its own
single-scene solve with equal GN iterations and poses within 1e-4 m (the
rounding of batched products taken in another order; the poses are about
60 m from the origin, where a float32 step is 4e-6 m); against the JAX
package's float32 solve on its own scenes (keys 0-2) at
``TestBenchConfig``'s 1e-4 m; the float64 port against the plain float64
reference of the benchmark (``bench_torch/reference/graph.py``, a dense
Cholesky of H) within 1e-8 m, and the float32 port within 1e-4 m, both
with equal GN iterations.  Each test runs on one torch thread; the
program's tensors stay under 32,768 elements (the reference's dense 600 x
600 H is the one larger tensor).
"""

import dataclasses
import importlib.util
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import tpuslam.slam.large as jlarge
from tpuslam.core.angles import wrap_angle as jwrap
from tpuslam.models.scan_sensor import ScanConfig as JScanConfig
from tpuslam.slam import GraphConfig as JGraphConfig
from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.models.scan_sensor import ScanConfig
from tpuslam_torch.slam import large, tridiag
from tpuslam_torch.slam.graph import GraphConfig, GraphObservations

N, LMS, W, S = 200, 20, 30, 3
SCAN = dict(range_m=15.0, angle_rad=math.radians(80.0), dist_gain=0.05,
            dir_sigma=math.radians(2.0), orient_sigma=math.radians(2.0))
CFG = GraphConfig(max_times=N, num_landmarks=LMS, max_gn_iters=10,
                  scan=ScanConfig(**SCAN), exact_jacobians=True)
KW = dict(odom_info=(100.0,) * 3, solver="tridiag", stall_ratio=0.5,
          delta_tol=1e-6 * N)
HARNESS = pathlib.Path(__file__).resolve().parents[1] / "bench_torch"


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(poses):
    rel = poses[..., 1:, :] - poses[..., :-1, :]
    return torch.cat([rel[..., :2], wrap_angle(rel[..., 2:])], dim=-1)


def _scene(seed, noise=True):
    """``(truth, odometry, observations)`` of a scene drawn from a torch
    generator; ``noise=False`` gives the noise-free scene (the odometry is
    the truth)."""
    g = torch.Generator().manual_seed(seed)
    offsets = torch.rand(LMS, generator=g) * 20.0 - 10.0
    perm = torch.randperm(LMS, generator=g)
    scan = torch.randn((N, LMS, 3), generator=g)
    odo = torch.randn((N, 3), generator=g)
    if not noise:
        scan, odo = torch.zeros_like(scan), torch.zeros_like(odo)
    return large.make_large_scene_with_noise(CFG, N, LMS, offsets, perm,
                                             scan, odo, radius=0.3 * N,
                                             odom_noise=0.1)


def _edges(visible):
    """Each scene's windowed edges, padded with invalid slots to one
    length (as ``window_pairs_device`` pads them)."""
    lists = [large.window_pairs_device(v, W, 40 * N) for v in visible]
    e = max(int(n) for _, n in lists)
    return large.EdgeList(*(torch.stack([f[:e] for f in fields])
                            for fields in zip(*(el for el, _ in lists))))


def _batch(scenes):
    """Stacked ``(odometry, observations, edges, rel_odom)`` of scenes."""
    odo = torch.stack([po for _, po, _ in scenes])
    obs = GraphObservations(*(torch.stack(f) for f in
                              zip(*(o for _, _, o in scenes))))
    return odo, obs, _edges([o.valid for _, _, o in scenes]), _rel(odo)


def _one(batch, s):
    """Scene s of a batch, with its share of the padded edge list."""
    odo, obs, edges, rel = batch
    return (odo[s], GraphObservations(*(f[s] for f in obs)),
            large.EdgeList(*(f[s] for f in edges)), rel[s])


def _solve(poses, obs, edges, rel, cfg=CFG, **kw):
    return large.graph_solve_banded(cfg, poses, obs, edges, band=W,
                                    rel_odom=rel, **{**KW, **kw})


def _f64(batch):
    odo, obs, edges, rel = batch
    return (odo.double(), GraphObservations(
        *(f.double() for f in obs[:3]), obs.valid), edges, rel.double())


@pytest.fixture(scope="module")
def batch():
    return _batch([_scene(s) for s in range(S)])


@pytest.fixture(scope="module")
def batched(batch):
    return _solve(*batch)


def test_each_scene_is_its_own_solve(batch, batched):
    assert batched.poses.shape == (S, N, 3)
    assert batched.gn_iters.shape == batched.delta_sum.shape == (S,)
    for s in range(S):
        one = _solve(*_one(batch, s))
        assert int(batched.gn_iters[s]) == int(one.gn_iters)
        torch.testing.assert_close(batched.poses[s], one.poses, rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(batched.delta_sum[s], one.delta_sum,
                                   rtol=1e-3, atol=0)


def test_scenes_run_in_lockstep_with_one_read_a_pass(batch):
    syncs, passes = large.sync_count, large.gn_passes
    res = _solve(*batch)
    n_passes = large.gn_passes - passes
    assert n_passes == int(res.gn_iters.max())
    # The grouping's read and one a pass, whatever S; the cap ends the
    # loop without one.
    assert large.sync_count - syncs == 1 + n_passes


def test_a_stopped_scene_keeps_its_poses():
    """A noise-free scene stops after one pass while the others go on;
    its poses are its own one-pass solve's."""
    still = _scene(7, noise=False)
    b = _batch([still, _scene(0), _scene(1)])
    res = _solve(*b)
    alone = _solve(*_one(b, 0))
    assert int(res.gn_iters[0]) == int(alone.gn_iters) == 1
    assert int(res.gn_iters[1:].min()) > 1
    torch.testing.assert_close(res.poses[0], alone.poses, rtol=0, atol=1e-4)
    torch.testing.assert_close(res.delta_sum[0], alone.delta_sum, rtol=1e-3,
                               atol=1e-12)


@pytest.mark.parametrize("bad", [None, 1], ids=["pd", "scene_1_not_pd"])
def test_batched_thomas_chain_is_each_scenes_own(bad):
    """The factor and resolve with a scene axis against each scene's own
    (float64, so the batched products' order shows only at rounding).  A
    scene whose H is not positive definite solves to NaN, as alone, and
    leaves the others as they are."""
    g = torch.Generator().manual_seed(11)
    band, t1 = 4, 40
    h_flat = torch.randn((S, (band + 1) * 9, t1), generator=g,
                         dtype=torch.float64) * 0.1
    h_flat[:, 0:9:4] += 10.0  # diagonally dominant: positive definite
    if bad is not None:
        h_flat[bad, 0, 21] = 1e-3  # a pivot far below its coupling
        h_flat[bad, 9, 21] = 5.0
    b_flat = torch.randn((S, 3, t1), generator=g, dtype=torch.float64)
    fac = tridiag.banded_factor_tridiag_flat(h_flat, band)
    assert fac.factor.invs.shape[:2] == (t1 // band, S)
    x = tridiag.banded_resolve_tridiag_flat(fac, b_flat, band)
    assert x.shape == (S, t1, 3)
    for s in range(S):
        want = tridiag.banded_solve_tridiag_flat(h_flat[s], b_flat[s], band)
        assert bool(want.isnan().all()) == (s == bad)
        torch.testing.assert_close(x[s], want, rtol=0, atol=1e-12,
                                   equal_nan=True)


@pytest.mark.parametrize("kw, name", [
    (dict(solver="cg"), "solver='cg'"),
    (dict(solver="cr"), "solver='cr'"),
    (dict(solver="cholesky"), "solver='cholesky'"),
    (dict(relinearize_omega=True), "relinearize_omega"),
    (dict(relinearize_omega=True, refactor_every=2), "relinearize_omega"),
    (dict(refactor_every=2), "refactor_every"),
    (dict(n_parts=2), "n_parts"),
    (dict(reuse_factorization=False), "reuse_factorization"),
])
def test_other_paths_refuse_a_scene_axis(batch, kw, name):
    with pytest.raises(ValueError, match=name):
        _solve(*batch, **kw)


def test_inexact_jacobians_refuse_a_scene_axis(batch):
    cfg = dataclasses.replace(CFG, exact_jacobians=False)
    with pytest.raises(ValueError, match="exact_jacobians"):
        _solve(*batch, cfg=cfg)


# --- Against the JAX package ----------------------------------------------

def test_matches_jax_on_its_scenes():
    """The JAX package's scenes for keys 0-2 and its float32 solve of each
    (one jitted program for all three: the edge lists padded to one
    length), against one batched solve of the three."""
    jcfg = JGraphConfig(max_times=N, num_landmarks=LMS, max_gn_iters=10,
                        scan=JScanConfig(**SCAN), exact_jacobians=True)
    make = jax.jit(lambda k: jlarge.make_large_scene(
        jcfg, k, N, LMS, radius=0.3 * N, odom_noise=0.1))
    scenes = [jax.tree_util.tree_map(np.asarray, make(jax.random.key(k)))
              for k in range(S)]
    lists = [jlarge.window_pairs(obs.valid, window=W) for _, _, obs in scenes]
    e = max(len(el.t_b) for el in lists)

    def pad(a, fill):
        a = np.asarray(a)
        return np.concatenate([a, np.full(e - len(a), fill, a.dtype)])

    lists = [jlarge.EdgeList(pad(el.t_b, 0), pad(el.t_a, 0), pad(el.lm, 0),
                             pad(el.valid, False)) for el in lists]

    def jax_solve(po, obs, el):
        rel = po[1:] - po[:-1]
        rel = rel.at[:, 2].set(jwrap(rel[:, 2]))
        return jlarge.graph_solve_banded(jcfg, po, obs, el, band=W,
                                         rel_odom=rel, **KW)

    solve = jax.jit(jax_solve)
    want = [jax.tree_util.tree_map(np.asarray, solve(po, obs, el))
            for (_, po, obs), el in zip(scenes, lists)]

    odo = torch.stack([torch.from_numpy(np.array(po)) for _, po, _ in scenes])
    obs = GraphObservations(*(
        torch.stack([torch.from_numpy(np.array(getattr(o, f)))
                     for _, _, o in scenes])
        for f in GraphObservations._fields))
    edges = large.EdgeList(*(
        torch.stack([torch.from_numpy(np.array(f).astype(dt))
                     for f in fields])
        for fields, dt in zip(zip(*lists),
                              (np.int64, np.int64, np.int64, bool))))
    got = _solve(odo, obs, edges, _rel(odo))
    for s in range(S):
        assert int(got.gn_iters[s]) == int(want[s].gn_iters)
        np.testing.assert_allclose(got.poses[s].numpy(), want[s].poses,
                                   rtol=0, atol=1e-4)


# --- Against the benchmark's plain reference -------------------------------

@pytest.fixture(scope="module")
def reference():
    sys.path.insert(0, str(HARNESS))
    try:
        spec = importlib.util.spec_from_file_location(
            "graph_reference", HARNESS / "reference" / "graph.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(HARNESS))
    return mod


def _reference_solves(reference, batch):
    scene = {"scan": SCAN, "anchor": CFG.anchor,
             "odom_info": list(KW["odom_info"]), "max_gn_iters": 10,
             "delta_tol": KW["delta_tol"], "stall_ratio": KW["stall_ratio"]}
    out = []
    for s in range(S):
        odo, obs, _, rel = _one(batch, s)
        out.append(reference.solve(
            scene, odo, dict(zip(GraphObservations._fields, obs)), rel, W))
    return out


@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-8),
                                         (torch.float32, 1e-4)])
def test_matches_the_plain_reference(reference, batch, dtype, atol):
    """The plain reference builds its own edges from the visibility, a
    dense H and one Cholesky; the batched port agrees scene by scene."""
    want = _reference_solves(reference, batch)
    got = _solve(*(_f64(batch) if dtype == torch.float64 else batch))
    for s in range(S):
        assert int(got.gn_iters[s]) == want[s]["gn_iters"]
        torch.testing.assert_close(got.poses[s].double(), want[s]["poses"],
                                   rtol=0, atol=atol)
