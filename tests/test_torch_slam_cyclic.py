"""Block cyclic reduction in the port (``tpuslam_torch/slam/cyclic.py``)
against the JAX package (``tests/test_large_graph.py``'s
``TestCyclicReductionSolver`` and ``TestFlatCr``).

Inputs are made from a numpy seed, or are the JAX package's own 100-pose
scene (key 3) carried across as numpy.  Tolerances: the float64 port
against the float64 JAX package at 1e-10 of the largest magnitude, with
equal ``gn_iters``; float32 solves against the true solution at a
relative 1e-4 (JAX's bound), against the port's Thomas solve at 1e-4,
and the flat layout against the block layout at ``rtol 2e-4, atol
2e-5``; float32 GN runs against another solver's at 2e-2 (JAX's
cross-solver bound) or 5e-3.  The super-block size rule equals JAX's
exactly.  Each test runs on one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.slam.cyclic as jcyc
from test_torch_slam_large import _port_scene, _rel_odom
from test_torch_slam_tridiag import (_band_of, _banded_system, _close,
                                     _dense_of_flat, _jit, _port_args,
                                     _random_flat, _t, _x64, jax_gn,
                                     jax_scene)
import tpuslam_torch.slam as tslam
import tpuslam_torch.slam.cyclic as tcyc
import tpuslam_torch.slam.tridiag as ttri


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("t1,band,ss", [(23, 4, None), (23, 4, 8),
                                        (64, 3, 4), (5, 1, None)])
def test_cr_matches_dense_and_jax(rng, t1, band, ss):
    a, hb, x_true, rhs = _banded_system(rng, t1, band)
    x = tcyc.banded_solve_cr(_t(hb.astype(np.float32)),
                             _t(rhs.reshape(t1, 3).astype(np.float32)),
                             super_size=ss)
    rel = np.linalg.norm(x.numpy().ravel() - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-4
    x64 = tcyc.banded_solve_cr(_t(hb), _t(rhs.reshape(t1, 3)),
                               super_size=ss)
    _close(x64.numpy().ravel(), np.linalg.solve(a, rhs), rtol=1e-8)
    with _x64():
        want = _jit(jcyc.banded_solve_cr, 2)(
            jnp.asarray(hb), jnp.asarray(rhs.reshape(t1, 3)), ss)
    _close(x64, want)


def test_block_cr_matches_thomas_and_jax(rng):
    """``block_cr_solve`` equals the Thomas solve on a random SPD
    block-tridiagonal system of a power-of-two N."""
    n, m = 8, 6
    u = rng.normal(size=(n - 1, m, m)) * 0.2
    d = np.stack([np.eye(m) * 4.0 + 0.1 * (lambda q: q + q.T)(
        rng.normal(size=(m, m))) for _ in range(n)])
    b = rng.normal(size=(n, m))
    d32, u32, b32 = (_t(a.astype(np.float32)) for a in (d, u, b))
    np.testing.assert_allclose(
        tcyc.block_cr_solve(d32, u32, b32).numpy(),
        ttri.block_thomas_solve(d32, u32, b32).numpy(), atol=1e-4)
    with _x64():
        want = _jit(jcyc.block_cr_solve)(jnp.asarray(d), jnp.asarray(u),
                                         jnp.asarray(b))
    _close(tcyc.block_cr_solve(_t(d), _t(u), _t(b)), want)
    with pytest.raises(ValueError, match="power of two"):
        tcyc.block_cr_solve(_t(d[:6]), _t(u[:5]), _t(b[:6]))


@pytest.mark.parametrize("t1,band,s", [(48, 4, 8), (60, 3, 4),
                                       (40, 5, None), (23, 4, None)])
def test_flat_cr_matches_band_cr_and_jax(rng, t1, band, s):
    h_flat, b = _random_flat(rng, t1, band)
    h32, b32 = _t(h_flat.astype(np.float32)), _t(b.astype(np.float32))
    x_band = tcyc.banded_solve_cr(_t(_band_of(h32.numpy(), band)), b32.T,
                                  super_size=s)
    x_flat = tcyc.banded_solve_cr_flat(h32, b32, band, super_size=s)
    np.testing.assert_allclose(x_flat.numpy(), x_band.numpy(), rtol=2e-4,
                               atol=2e-5)
    x64 = tcyc.banded_solve_cr_flat(_t(h_flat), _t(b), band, super_size=s)
    with _x64():
        want = _jit(jcyc.banded_solve_cr_flat, 2, 3)(
            jnp.asarray(h_flat), jnp.asarray(b), band, s)
    _close(x64, want)
    _close(x64.numpy().reshape(-1),
           np.linalg.solve(_dense_of_flat(h_flat, band), b.T.reshape(-1)))


#: (band, T1): the tests' systems, the GN scenes, and band 40 at
#: bench_graph_large's 10k, 100k and 1M poses (S = 40; N padded from
#: 250, 2500 and 25,000 super-blocks to 256, 4096 and 32,768).
PICKS = [(4, 23), (3, 64), (1, 5), (5, 40), (3, 60), (20, 100), (12, 200),
         (50, 1000), (40, 10_000), (40, 100_000), (40, 1_000_000)]


def test_pick_super_size_matches_jax():
    got = [tcyc._pick_super_size(band, t1) for band, t1 in PICKS]
    assert got == [jcyc._pick_super_size(band, t1) for band, t1 in PICKS]
    assert got[-3:] == [40, 40, 40]


@pytest.fixture(scope="module")
def scene():
    """The JAX package's 100-pose scene (key 3) and JAX's float64 GN
    solve of it with ``solver="cr"``."""
    out = jax_scene()
    out["want64"] = jax_gn(out, {"cr": {"solver": "cr"}}, x64=True)["cr"]
    return out


def test_cr_gn_float64_matches_jax(scene):
    cfg, po, obs, el, kw = _port_args(scene, torch.float64)
    got = tslam.graph_solve_banded(cfg, po, obs, el, solver="cr", **kw)
    want = scene["want64"]
    assert int(got.gn_iters) == int(want.gn_iters)
    assert int(got.cg_iters_last) == int(want.cg_iters_last) == 0
    _close(got.poses, want.poses)
    _close(got.delta_sum, want.delta_sum, rtol=1e-6)


def test_cr_gn_agrees_with_tridiag(scene):
    """``TestCyclicReductionSolver.test_cr_solver_option_in_gn``: float32
    CR and Thomas GN on the same scene."""
    cfg, po, obs, el, kw = _port_args(scene, torch.float32)
    r_cr = tslam.graph_solve_banded(cfg, po, obs, el, solver="cr", **kw)
    r_td = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                    **kw)
    np.testing.assert_allclose(r_cr.poses.numpy(), r_td.poses.numpy(),
                               atol=2e-2)


def test_graph_solve_tridiag_and_cr_agree():
    """``TestFlatTridiag.test_graph_solve_tridiag_uses_flat``'s config
    (200 poses, 30 landmarks, band 12) on the port's own scene."""
    cfg, pt, po, obs = _port_scene(0, 200, 30, 60.0, 0.05, max_gn_iters=6)
    el = tslam.window_pairs(obs.valid, window=12)
    kw = dict(band=12, rel_odom=_rel_odom(po),
              odom_info=(100.0, 100.0, 100.0), delta_tol=1e-4 * 200)
    r_td = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag", **kw)
    r_cr = tslam.graph_solve_banded(cfg, po, obs, el, solver="cr", **kw)
    assert np.isfinite(r_cr.poses.numpy()).all()
    assert int(r_cr.gn_iters) >= 1
    np.testing.assert_allclose(r_cr.poses.numpy(), r_td.poses.numpy(),
                               atol=5e-3)


def test_cr_gives_nan_where_jax_does(rng):
    """A block that is not positive definite: JAX's Cholesky gives NaN,
    and so does the port's unchecked one, with no error."""
    n, m = 4, 3
    d = np.stack([np.eye(m) * 4.0] * n)
    d[1] = -np.eye(m)
    u = rng.normal(size=(n - 1, m, m)) * 0.2
    b = rng.normal(size=(n, m))
    with _x64():
        want = np.asarray(_jit(jcyc.block_cr_solve)(
            jnp.asarray(d), jnp.asarray(u), jnp.asarray(b)))
    got = tcyc.block_cr_solve(_t(d), _t(u), _t(b)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
