"""The super-block Thomas solver of the port (``tpuslam_torch/slam/
tridiag.py``) and its Gauss-Newton loops against the JAX package.

Inputs are made from a numpy seed, or are the JAX package's own scene
carried across as numpy.  Tolerances: the float64 port against the
float64 JAX package at 1e-10 of the largest magnitude (the placements,
pads and interleaves exactly); float32 solves against a dense float64
solve at ``tests/test_large_graph.py``'s bounds; the staged solves
(factor then substitute, factor then resolve) against the one-shot ones
bit for bit.  GN runs hold equal ``gn_iters``.  Each test runs on one
torch thread.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.slam.large as jlarge
import tpuslam.slam.tridiag as jtri
from tpuslam.core.angles import wrap_angle as jwrap
from tpuslam.models.scan_sensor import ScanConfig
from tpuslam.slam import GraphConfig
from tpuslam_torch.convert import (edge_list_from_numpy, graph_config_from,
                                   graph_observations_from_numpy)
from tpuslam_torch.core.angles import wrap_angle as twrap
from tpuslam_torch.slam import GraphObservations
import tpuslam_torch.slam.large as tlarge
import tpuslam_torch.slam.tridiag as ttri

F64 = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol=F64):
    """Arrays equal to ``rtol`` of the largest magnitude."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _cfg(t1, num_lm, **kw):
    return GraphConfig(
        max_times=t1, num_landmarks=num_lm,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)), **kw)


def _random_flat(rng, t1, band, dtype=np.float64):
    """A random SPD-ish flat banded system (``test_large_graph.py``'s
    ``TestFlatTridiag._random_banded``)."""
    d1 = band + 1
    h_flat = np.zeros((d1 * 9, t1))
    for d in range(d1):
        blk = rng.normal(size=(t1, 3, 3)) * 0.3
        if d == 0:
            blk = 0.5 * (blk + blk.transpose(0, 2, 1))
            blk += np.eye(3)[None] * (band + 4.0)
        h_flat[d * 9:(d + 1) * 9] = blk.reshape(t1, 9).T
        if d:
            h_flat[d * 9:(d + 1) * 9, t1 - d:] = 0.0
    return h_flat.astype(dtype), rng.normal(size=(3, t1)).astype(dtype)


def _band_of(h_flat, band):
    t1 = h_flat.shape[1]
    return h_flat.reshape(band + 1, 9, t1).transpose(0, 2, 1).reshape(
        band + 1, t1, 3, 3)


def _dense_of_flat(h_flat, band):
    """The dense symmetric matrix of flat upper-band storage."""
    t1 = h_flat.shape[1]
    hb = _band_of(np.asarray(h_flat, np.float64), band)
    h = np.zeros((3 * t1, 3 * t1))
    for d in range(band + 1):
        for i in range(t1 - d):
            h[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3] += hb[d, i]
            if d:
                h[3 * (i + d):3 * (i + d) + 3, 3 * i:3 * i + 3] += hb[d, i].T
    return h


def _random_tridiag(rng, n=6, m=9):
    mats = rng.normal(size=(n, m, m))
    diag = mats @ mats.transpose(0, 2, 1) + 8.0 * np.eye(m)
    return diag, rng.normal(size=(n - 1, m, m)) * 0.1


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, *static):
    """``fn`` compiled once by JAX, its Python ints static (eager JAX
    compiles every operation on its own)."""
    return jax.jit(fn, static_argnums=static)


# --- Re-tiling, prescale and interleave: the same scalars as JAX ---------

@pytest.mark.parametrize("t1,band,s", [(24, 4, 8), (24, 3, 4)])
def test_band_to_tridiag_matches_jax(rng, t1, band, s):
    h_flat, _ = _random_flat(rng, t1, band)
    hb = _band_of(h_flat, band)
    with _x64():
        want = _jit(jtri.band_to_tridiag, 1)(jnp.asarray(hb), s)
    got = ttri.band_to_tridiag(_t(hb), s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("t1,band,s,drop_last",
                         [(48, 4, 8, True), (60, 3, 12, True),
                          (40, 5, 5, False)])
def test_flat_to_tridiag_matches_jax(rng, t1, band, s, drop_last):
    """The gathers place exactly the scalars of JAX's one-hot matmuls."""
    h_flat, _ = _random_flat(rng, t1, band)
    with _x64():
        want = _jit(jtri._flat_to_tridiag, 1, 2, 3)(
            jnp.asarray(h_flat), band, s, drop_last)
    got = ttri._flat_to_tridiag(_t(h_flat), band, s, drop_last=drop_last)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_flat_to_tridiag_equals_band_to_tridiag(rng):
    t1, band, s = 48, 4, 8
    h_flat, _ = _random_flat(rng, t1, band)
    flat = ttri._flat_to_tridiag(_t(h_flat), band, s)
    blocks = ttri.band_to_tridiag(_t(_band_of(h_flat, band)), s)
    for f, b in zip(flat, blocks):
        np.testing.assert_array_equal(f.numpy(), b.numpy())


def test_row_interleave_matches_jax(rng):
    b = rng.normal(size=(3, 40))
    with _x64():
        want = jtri.flat_rows_to_super(jnp.asarray(b), 8)
        back = jtri.super_rows_to_flat(want, 8)
    got = ttri.flat_rows_to_super(_t(b), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ttri.super_rows_to_flat(got, 8).numpy(),
                                  np.asarray(back))
    np.testing.assert_array_equal(np.asarray(back), b)


def test_prescale_and_pads_match_jax(rng):
    t1, band = 23, 4
    h_flat, b = _random_flat(rng, t1, band)
    hb = _band_of(h_flat, band)
    with _x64():
        jh, jb, jscaled, jhb, jbb, jband = _jit(
            lambda h, b, hb: (*jtri.pad_flat(h, b, 8),
                              jtri._flat_prescale(*jtri.pad_flat(h, b, 8),
                                                  band),
                              *jtri.pad_band(hb, b.T, 8),
                              jtri.jacobi_prescale(*jtri.pad_band(hb, b.T,
                                                                  8))))(
            jnp.asarray(h_flat), jnp.asarray(b), jnp.asarray(hb))
    th, tb = ttri.pad_flat(_t(h_flat), _t(b), 8)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for g, w in zip(ttri._flat_prescale(th, tb, band), jscaled):
        _close(g, w)
    thb, tbb = ttri.pad_band(_t(hb), _t(b.T), 8)
    np.testing.assert_array_equal(thb.numpy(), np.asarray(jhb))
    np.testing.assert_array_equal(tbb.numpy(), np.asarray(jbb))
    for g, w in zip(ttri.jacobi_prescale(thb, tbb), jband):
        _close(g, w)


# --- Block Thomas --------------------------------------------------------

def test_thomas_matches_jax_and_dense(rng):
    diag, upper = _random_tridiag(rng)
    b = rng.normal(size=(6, 9))
    b2 = rng.normal(size=(6, 4, 9))
    with _x64():
        jfac, want, want2 = _jit(lambda d, u, b, b2: (
            jtri.block_thomas_factor(d, u), jtri.block_thomas_solve(d, u, b),
            jtri.block_thomas_solve(d, u, b2)))(
            jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(b),
            jnp.asarray(b2))
    fac = ttri.block_thomas_factor(_t(diag), _t(upper))
    for g, w in zip(fac, jfac):
        _close(g, w)
    _close(ttri.block_thomas_solve(_t(diag), _t(upper), _t(b)), want)
    _close(ttri.block_thomas_solve(_t(diag), _t(upper), _t(b2)), want2)
    # and a dense numpy solve of the same system
    n, m = diag.shape[0], diag.shape[1]
    dense = np.zeros((n * m, n * m))
    for k in range(n):
        dense[k * m:(k + 1) * m, k * m:(k + 1) * m] = diag[k]
        if k + 1 < n:
            dense[k * m:(k + 1) * m, (k + 1) * m:(k + 2) * m] = upper[k]
            dense[(k + 1) * m:(k + 2) * m, k * m:(k + 1) * m] = upper[k].T
    x = ttri.block_thomas_solve(_t(diag), _t(upper), _t(b)).numpy()
    _close(x.reshape(-1), np.linalg.solve(dense, b.reshape(-1)))


def test_factor_substitute_bit_matches_solve(rng):
    diag, upper = (_t(a.astype(np.float32)) for a in _random_tridiag(rng))
    b = _t(rng.normal(size=(6, 9)).astype(np.float32))
    want = ttri.block_thomas_solve(diag, upper, b)
    got = ttri.block_thomas_substitute(
        ttri.block_thomas_factor(diag, upper), b)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    b2 = _t(rng.normal(size=(6, 4, 9)).astype(np.float32))
    want2 = ttri.block_thomas_solve(diag, upper, b2)
    got2 = ttri.block_thomas_substitute(
        ttri.block_thomas_factor(diag, upper), b2)
    assert got2.shape == (6, 4, 9)
    np.testing.assert_array_equal(got2.numpy(), want2.numpy())


def test_not_positive_definite_gives_nan(rng):
    """JAX's Cholesky gives NaN for a matrix that is not PD; the port's
    unchecked Cholesky gives a NaN factor there too, with no error."""
    diag, upper = _random_tridiag(rng)
    diag[2] = -np.eye(9)
    with _x64():
        jfac = _jit(jtri.block_thomas_factor)(jnp.asarray(diag),
                                              jnp.asarray(upper))
    fac = ttri.block_thomas_factor(_t(diag), _t(upper))
    assert np.isfinite(fac.invs[:2].numpy()).all()
    assert np.isnan(fac.invs[2].numpy()).all()
    assert np.isnan(np.asarray(jfac.invs[2])).all()
    np.testing.assert_array_equal(np.isnan(fac.invs.numpy()),
                                  np.isnan(np.asarray(jfac.invs)))


# --- Banded solves -------------------------------------------------------

def _banded_system(rng, t1, band, diag_boost=4.0):
    """``test_large_graph.py``'s random SPD banded system: ``(a, hb,
    x_true, rhs)``."""
    d1 = band + 1
    n = 3 * t1
    b_mat = rng.normal(size=(n, n)) * (
        np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3)
    a = b_mat @ b_mat.T + np.eye(n) * diag_boost
    for i in range(t1):
        for j in range(t1):
            if abs(i - j) > band:
                a[3 * i:3 * i + 3, 3 * j:3 * j + 3] = 0
    a = (a + a.T) / 2 + np.eye(n) * diag_boost
    hb = np.zeros((d1, t1, 3, 3))
    for d in range(d1):
        for i in range(t1 - d):
            hb[d, i] = a[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3]
    x_true = rng.normal(size=n)
    return a, hb, x_true, a @ x_true


@pytest.mark.parametrize("super_size", [None, 8])
def test_banded_solve_matches_dense(rng, super_size):
    t1, band = 23, 4
    a, hb, x_true, rhs = _banded_system(rng, t1, band)
    x = ttri.banded_solve_tridiag(_t(hb.astype(np.float32)),
                                  _t(rhs.reshape(t1, 3).astype(np.float32)),
                                  super_size=super_size)
    rel = np.linalg.norm(x.numpy().ravel() - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-4
    x64 = ttri.banded_solve_tridiag(_t(hb), _t(rhs.reshape(t1, 3)),
                                    super_size=super_size)
    _close(x64.numpy().ravel(), np.linalg.solve(a, rhs))
    with _x64():
        want = _jit(jtri.banded_solve_tridiag, 2)(
            jnp.asarray(hb), jnp.asarray(rhs.reshape(t1, 3)), super_size)
    _close(x64, want)


@pytest.mark.parametrize("t1,band,s", [(48, 4, 8), (60, 3, 12), (40, 5, 5)])
def test_flat_solve_matches_band_solver_and_jax(rng, t1, band, s):
    h_flat, b = _random_flat(rng, t1, band)
    h32, b32 = _t(h_flat.astype(np.float32)), _t(b.astype(np.float32))
    x_band = ttri.banded_solve_tridiag(_t(_band_of(h32.numpy(), band)),
                                       b32.T, super_size=s)
    x_flat = ttri.banded_solve_tridiag_flat(h32, b32, band, super_size=s)
    np.testing.assert_allclose(x_flat.numpy(), x_band.numpy(), rtol=2e-4,
                               atol=2e-5)
    x64 = ttri.banded_solve_tridiag_flat(_t(h_flat), _t(b), band,
                                         super_size=s)
    with _x64():
        want = _jit(jtri.banded_solve_tridiag_flat, 2, 3)(
            jnp.asarray(h_flat), jnp.asarray(b), band, s)
    _close(x64, want)
    _close(x64.numpy().reshape(-1),
           np.linalg.solve(_dense_of_flat(h_flat, band), b.T.reshape(-1)))


@pytest.mark.parametrize("ss", [8, 16])
def test_flat_factor_resolve_matches_one_shot(rng, ss):
    t1, band = 23, 4
    a, hb, _, _ = _banded_system(rng, t1, band, diag_boost=8.0)
    h_flat = _t(hb.reshape(band + 1, t1, 9).transpose(0, 2, 1)
                .reshape((band + 1) * 9, t1).astype(np.float32))
    rhs = _t(rng.normal(size=(3, t1)).astype(np.float32))
    want = ttri.banded_solve_tridiag_flat(h_flat, rhs, band, super_size=ss)
    fac = ttri.banded_factor_tridiag_flat(h_flat, band, super_size=ss)
    got = ttri.banded_resolve_tridiag_flat(fac, rhs, ss)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_refusals(rng):
    h_flat, _ = _random_flat(rng, 24, 4)
    with pytest.raises(ValueError, match="exceeds super block size"):
        ttri._flat_to_tridiag(_t(h_flat), 4, 3)
    with pytest.raises(ValueError, match="exceeds super block size"):
        ttri.band_to_tridiag(_t(_band_of(h_flat, 4)), 3)
    with pytest.raises(ValueError, match="not a multiple"):
        ttri.band_to_tridiag(_t(_band_of(h_flat, 4)), 5)
    with pytest.raises(NotImplementedError, match="item 4"):
        ttri.banded_factor_tridiag_flat(_t(h_flat), 4, 8, n_parts=3)


# --- The GN loops on the JAX package's scene -----------------------------

NOISE = 0.3
T1, LMS, WINDOW = 100, 20, 20
GN_RUNS = {
    "reuse": {},
    "refactor_1": {"relinearize_omega": True, "refactor_every": 1},
    "refactor_3": {"relinearize_omega": True, "refactor_every": 3},
    "once_damped": {"reuse_factorization": False, "damping": 0.5},
}


@pytest.fixture(scope="module")
def scene():
    """The JAX package's 100-pose scene (key 3, ``TestFactorReuse``'s) as
    numpy, its host edge list, and float64 JAX solves of each GN run."""
    cfg = _cfg(T1, LMS, max_gn_iters=10, exact_jacobians=True)
    pt, po, obs = jax.jit(lambda k: jlarge.make_large_scene(
        cfg, k, T1, LMS, radius=40.0, odom_noise=NOISE))(jax.random.key(3))
    pt, po = np.asarray(pt), np.asarray(po)
    obs = jax.tree_util.tree_map(np.asarray, obs)
    el = jlarge.window_pairs(obs.valid, window=WINDOW)
    el = jax.tree_util.tree_map(np.asarray, el)

    def solve(runs):
        def fn(po, obs, el):
            rel = po[1:] - po[:-1]
            rel = rel.at[:, 2].set(jwrap(rel[:, 2]))
            return {name: jlarge.graph_solve_banded(
                cfg, po, obs, el, band=WINDOW, rel_odom=rel,
                odom_info=(1 / NOISE ** 2,) * 3, solver="tridiag", **kw)
                for name, kw in runs.items()}
        return jax.jit(fn)

    want32 = jax.tree_util.tree_map(
        np.asarray, solve({"reuse": {}})(po, obs, el))["reuse"]
    with _x64():
        obs64 = type(obs)(*(a.astype(np.float64) for a in obs[:3]),
                          obs.valid)
        want64 = jax.tree_util.tree_map(
            np.asarray, solve(GN_RUNS)(po.astype(np.float64), obs64, el))
    return {"cfg": cfg, "pt": pt, "po": po, "obs": obs, "el": el,
            "want32": want32, "want64": want64}


def _port_args(scene, dtype):
    obs = graph_observations_from_numpy(scene["obs"], device="cpu")
    obs = GraphObservations(*(t.to(dtype) for t in obs[:3]), obs.valid)
    po = torch.from_numpy(np.array(scene["po"])).to(dtype)
    rel = po[1:] - po[:-1]
    rel = torch.cat([rel[:, :2], twrap(rel[:, 2:3])], dim=1)
    el = edge_list_from_numpy(scene["el"], device="cpu")
    kw = dict(band=WINDOW, rel_odom=rel, odom_info=(1 / NOISE ** 2,) * 3)
    return graph_config_from(scene["cfg"]), po, obs, el, kw


@pytest.mark.parametrize("name", list(GN_RUNS))
def test_gn_float64_matches_jax(scene, name):
    cfg, po, obs, el, kw = _port_args(scene, torch.float64)
    got = tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                    **GN_RUNS[name], **kw)
    want = scene["want64"][name]
    assert int(got.gn_iters) == int(want.gn_iters)
    _close(got.poses, want.poses)
    _close(got.delta_sum, want.delta_sum, rtol=1e-6)


def test_reuse_gn_matches_one_shot_and_jax(scene):
    cfg, po, obs, el, kw = _port_args(scene, torch.float32)
    r_reuse = tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                        **kw)  # auto-enabled
    r_once = tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                       reuse_factorization=False, **kw)
    assert int(r_reuse.gn_iters) == int(r_once.gn_iters)
    np.testing.assert_allclose(r_reuse.poses.numpy(), r_once.poses.numpy(),
                               atol=1e-5)
    want = scene["want32"]
    assert int(r_reuse.gn_iters) == int(want.gn_iters)
    np.testing.assert_allclose(r_reuse.poses.numpy(), want.poses, atol=1e-4)


def test_stall_ratio_stops_at_noise_floor(scene):
    """With ``delta_tol`` below the float32 noise floor the absolute
    criterion runs to the cap; the stall check stops earlier at no cost
    in RMSE (the JAX package's own property)."""
    _, po, obs, el, kw = _port_args(scene, torch.float32)
    cfg40 = graph_config_from(_cfg(T1, LMS, max_gn_iters=40,
                                   exact_jacobians=True))
    r_max = tlarge.graph_solve_banded(cfg40, po, obs, el, solver="tridiag",
                                      delta_tol=0.0, **kw)
    r_stall = tlarge.graph_solve_banded(cfg40, po, obs, el,
                                        solver="tridiag", delta_tol=0.0,
                                        stall_ratio=0.5, **kw)
    assert int(r_max.gn_iters) == cfg40.max_gn_iters
    assert int(r_stall.gn_iters) < cfg40.max_gn_iters
    pt = torch.from_numpy(scene["pt"])

    def rmse(r):
        return float(((r.poses[:, :2] - pt[:, :2]) ** 2).sum(-1).mean()
                     .sqrt())

    assert rmse(r_stall) <= rmse(r_max) + 1e-3


def test_refactor_every_one_is_full_relinearization(scene):
    cfg, po, obs, el, kw = _port_args(scene, torch.float32)
    r_full = tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                       relinearize_omega=True,
                                       reuse_factorization=False, **kw)
    r_k1 = tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                     relinearize_omega=True,
                                     refactor_every=1, **kw)
    assert int(r_k1.gn_iters) == int(r_full.gn_iters)
    np.testing.assert_allclose(r_k1.poses.numpy(), r_full.poses.numpy(),
                               atol=1e-4)


def test_refactor_every_k_converges_to_same_poses(scene):
    _, po, obs, el, kw = _port_args(scene, torch.float32)
    cfg30 = graph_config_from(_cfg(T1, LMS, max_gn_iters=30,
                                   exact_jacobians=True))
    r_full = tlarge.graph_solve_banded(cfg30, po, obs, el, solver="tridiag",
                                       relinearize_omega=True,
                                       reuse_factorization=False,
                                       delta_tol=1e-6, **kw)
    for k in (2, 3, 5):
        r_k = tlarge.graph_solve_banded(cfg30, po, obs, el,
                                        solver="tridiag",
                                        relinearize_omega=True,
                                        refactor_every=k, delta_tol=1e-6,
                                        **kw)
        np.testing.assert_allclose(r_k.poses.numpy(), r_full.poses.numpy(),
                                   atol=2e-4, err_msg=f"refactor_every={k}")
        assert float(r_k.delta_sum) < 1e-6
        assert int(r_k.gn_iters) <= int(r_full.gn_iters) + 4


def test_reuse_and_refactor_validation(scene):
    cfg, po, obs, el, kw = _port_args(scene, torch.float32)
    with pytest.raises(ValueError, match="reuse_factorization"):
        tlarge.graph_solve_banded(cfg, po, obs, el, solver="cg",
                                  reuse_factorization=True, **kw)
    with pytest.raises(ValueError, match="reuse_factorization"):
        tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                  relinearize_omega=True,
                                  reuse_factorization=True, **kw)
    with pytest.raises(ValueError, match="refactor_every"):
        tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                  refactor_every=0, relinearize_omega=True,
                                  **kw)
    with pytest.raises(ValueError, match="refactor_every"):
        tlarge.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                  refactor_every=2, **kw)
    with pytest.raises(ValueError, match="refactor_every"):
        tlarge.graph_solve_banded(cfg, po, obs, el, solver="cg",
                                  refactor_every=2, relinearize_omega=True,
                                  **kw)
