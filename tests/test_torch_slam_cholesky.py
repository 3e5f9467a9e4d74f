"""The blocked banded Cholesky in the port (``tpuslam_torch/slam/
cholesky.py``) against the JAX package (``tests/test_large_graph.py``'s
``TestBandedCholesky`` and ``TestFlatCholesky``, and the cholesky half of
``TestFlatCg.test_graph_solve_cg_and_cholesky_flat_paths``).

Inputs are made from a numpy seed, or are the JAX package's own 100-pose
scene (key 3) carried across as numpy.  Tolerances: the float64 port
against the float64 JAX package at 1e-10 of the largest magnitude (the
factor, the solutions, the clamped 3x3 helpers on a block that is not
positive definite), with equal ``gn_iters``; the float32 factor against
numpy's dense Cholesky at 1e-5 and its solve at a relative 1e-5 (JAX's
bounds); the flat layout against the block layout at ``rtol 2e-4, atol
2e-5``; float32 GN runs against another solver's at 2e-2 (JAX's
cross-solver bound).  Each test runs on one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.slam.cholesky as jchol
from test_torch_slam_large import _port_scene, _rel_odom
from test_torch_slam_tridiag import (_band_of, _banded_system, _close,
                                     _dense_of_flat, _jit, _port_args,
                                     _random_flat, _t, _x64, jax_gn,
                                     jax_scene)
import tpuslam_torch.slam as tslam
import tpuslam_torch.slam.cholesky as tchol


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_factor_matches_dense_and_jax(rng):
    t1, band = 12, 3
    a, hb, x_true, rhs = _banded_system(rng, t1, band, diag_boost=5.0)
    lb = tchol.banded_cholesky(_t(hb.astype(np.float32)))
    x = tchol.banded_chol_solve(lb, _t(rhs.reshape(t1, 3)
                                       .astype(np.float32)))
    rel = np.linalg.norm(x.numpy().ravel() - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-5
    l_dense = np.linalg.cholesky(a)
    lb_np = lb.numpy()
    for d in range(band + 1):
        for i in range(t1 - d):
            np.testing.assert_allclose(
                lb_np[d, i],
                l_dense[3 * (i + d):3 * (i + d) + 3, 3 * i:3 * i + 3],
                atol=1e-5)
    lb64 = tchol.banded_cholesky(_t(hb))
    x64 = tchol.banded_solve_direct(_t(hb), _t(rhs))
    with _x64():
        jlb, jx = _jit(lambda h, r: (jchol.banded_cholesky(h),
                                     jchol.banded_solve_direct(h, r)))(
            jnp.asarray(hb), jnp.asarray(rhs))
    _close(lb64, jlb)
    _close(x64, jx)
    assert x64.shape == (3 * t1,)
    _close(x64.numpy(), np.linalg.solve(a, rhs), rtol=1e-8)


@pytest.mark.parametrize("t1,band", [(48, 4), (60, 3), (40, 5), (23, 4)])
def test_flat_matches_band_solver_and_jax(rng, t1, band):
    h_flat, b = _random_flat(rng, t1, band)
    h32, b32 = _t(h_flat.astype(np.float32)), _t(b.astype(np.float32))
    x_band = tchol.banded_solve_direct(_t(_band_of(h32.numpy(), band)),
                                       b32.T)
    x_flat = tchol.banded_solve_direct_flat(h32, b32, band)
    np.testing.assert_allclose(x_flat.numpy(), x_band.numpy(), rtol=2e-4,
                               atol=2e-5)
    x64 = tchol.banded_solve_direct_flat(_t(h_flat), _t(b), band)
    with _x64():
        want = _jit(jchol.banded_solve_direct_flat, 2)(
            jnp.asarray(h_flat), jnp.asarray(b), band)
    _close(x64, want)
    _close(x64.numpy().reshape(-1),
           np.linalg.solve(_dense_of_flat(h_flat, band), b.T.reshape(-1)))


def test_not_positive_definite_is_clamped_like_jax(rng):
    """A pivot at or below zero is clamped at 1e-30 in both packages:
    finite 3x3 factors of the same values.  In a banded solve the tiny
    pivot's inverse overflows the later steps, to NaN in both."""
    blocks = rng.normal(size=(4, 3, 3))
    blocks = blocks @ blocks.transpose(0, 2, 1)
    blocks[1] = -np.eye(3)  # every pivot negative
    blocks[2, 1, 1] = blocks[2, 1, 0] ** 2 / blocks[2, 0, 0]  # a zero one
    blocks[3, 2, 2] -= 50.0
    h_flat, b = _random_flat(rng, 10, 2)
    h_flat[:9, 4] = -np.eye(3).reshape(9)
    with _x64():
        jl, jinv, jx = _jit(lambda a, h, b: (
            jchol._chol3(a), jchol._inv_lower3(jchol._chol3(a)),
            jchol.banded_solve_direct_flat(h, b, 2)))(
            jnp.asarray(blocks), jnp.asarray(h_flat), jnp.asarray(b))
    lo = tchol._chol3(_t(blocks))
    assert np.isfinite(lo.numpy()).all()
    _close(lo, jl)
    _close(tchol._inv_lower3(lo), jinv)
    x = tchol.banded_solve_direct_flat(_t(h_flat), _t(b), 2).numpy()
    np.testing.assert_array_equal(np.isnan(x), np.isnan(np.asarray(jx)))
    assert np.isnan(x).any()


@pytest.fixture(scope="module")
def scene():
    """The JAX package's 100-pose scene (key 3) and JAX's float64 GN
    solve of it with ``solver="cholesky"``."""
    out = jax_scene()
    out["want64"] = jax_gn(out, {"ch": {"solver": "cholesky"}},
                           x64=True)["ch"]
    return out


def test_cholesky_gn_float64_matches_jax(scene):
    cfg, po, obs, el, kw = _port_args(scene, torch.float64)
    got = tslam.graph_solve_banded(cfg, po, obs, el, solver="cholesky",
                                   **kw)
    want = scene["want64"]
    assert int(got.gn_iters) == int(want.gn_iters)
    assert int(got.cg_iters_last) == int(want.cg_iters_last) == 0
    _close(got.poses, want.poses)
    _close(got.delta_sum, want.delta_sum, rtol=1e-6)


def test_cholesky_gn_agrees_with_cg(scene):
    """``TestBandedCholesky.test_solver_option_in_gn``: float32 Cholesky
    and CG GN on the same scene."""
    cfg, po, obs, el, kw = _port_args(scene, torch.float32)
    r_ch = tslam.graph_solve_banded(cfg, po, obs, el, solver="cholesky",
                                    **kw)
    r_cg = tslam.graph_solve_banded(cfg, po, obs, el, solver="cg", **kw)
    np.testing.assert_allclose(r_ch.poses.numpy(), r_cg.poses.numpy(),
                               atol=2e-2)


def test_graph_solve_cg_and_cholesky_flat_paths():
    """``TestFlatCg.test_graph_solve_cg_and_cholesky_flat_paths``'s config
    (200 poses, 30 landmarks, band 12) on the port's own scene: Cholesky
    and CG GN against the Thomas GN."""
    cfg, pt, po, obs = _port_scene(0, 200, 30, 60.0, 0.05, max_gn_iters=6)
    el = tslam.window_pairs(obs.valid, window=12)
    kw = dict(band=12, rel_odom=_rel_odom(po),
              odom_info=(100.0, 100.0, 100.0), delta_tol=1e-4 * 200)
    r_td = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag", **kw)
    r_ch = tslam.graph_solve_banded(cfg, po, obs, el, solver="cholesky",
                                    **kw)
    r_cg = tslam.graph_solve_banded(cfg, po, obs, el, solver="cg", **kw)
    assert np.isfinite(r_ch.poses.numpy()).all()
    np.testing.assert_allclose(r_ch.poses.numpy(), r_td.poses.numpy(),
                               atol=2e-2)
    np.testing.assert_allclose(r_cg.poses.numpy(), r_td.poses.numpy(),
                               atol=2e-2)
