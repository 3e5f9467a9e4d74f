"""The partitioned (SPIKE-style) Thomas factor of the port
(``tpuslam_torch/slam/tridiag.py::block_thomas_factor_partitioned``) and
its flat and GN paths, against the JAX package
(``tests/test_large_graph.py``'s ``TestTridiagSolver`` partitioned cases).

Inputs are made from a numpy seed, or are the JAX package's own 100-pose
scene (key 3) carried across as numpy.  Tolerances: the float64
partitioned solve against the port's sequential solve at 1e-12 of the
largest magnitude (JAX's bound), against JAX's partitioned solve (its
``"lax"`` and ``"blocked"`` forms) and the factor's fields against JAX's
at 1e-10, with equal ``gn_iters`` in GN; the float32 partitioned GN
against the sequential one at 5e-3 (JAX's bound).  Each test runs on one
torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.slam.tridiag as jtri
from test_torch_slam_tridiag import (_close, _jit, _port_args,
                                     _random_flat, _t, _x64, jax_gn,
                                     jax_scene)
import tpuslam_torch.slam as tslam
import tpuslam_torch.slam.tridiag as ttri


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chain(rng, n, m):
    """``TestTridiagSolver``'s random SPD block-tridiagonal system."""
    a = np.stack([np.eye(m) * (6 + i % 3) + 0.3 * rng.normal(size=(m, m))
                  for i in range(n)])
    a = 0.5 * (a + a.transpose(0, 2, 1))
    return a, 0.3 * rng.normal(size=(n - 1, m, m)), rng.normal(size=(n, m))


def _fields(fac):
    """The factor's tensors in a fixed order."""
    return (*fac.chunk, *fac.red, fac.b_cpl, fac.c_cpl)


@pytest.mark.parametrize("m_blk", [5, 6])
@pytest.mark.parametrize("c", [2, 4, 12])
def test_partitioned_matches_sequential_and_jax(rng, m_blk, c):
    """n = 24 blocks in chunks of 12, 6 and 2 (the last the reference's
    ``m == 2`` branches: no interior coupling, no reverse recursion)."""
    a, u, b = _chain(rng, 24, m_blk)
    fac = ttri.block_thomas_factor_partitioned(_t(a), _t(u), c)
    x = ttri.block_thomas_substitute_partitioned(fac, _t(b))
    _close(x, ttri.block_thomas_solve(_t(a), _t(u), _t(b)).numpy(),
           rtol=1e-12)
    with _x64():
        def ref(a, u, b):
            out = {}
            for impl in ("lax", "blocked"):
                f = jtri.block_thomas_factor_partitioned(a, u, c,
                                                         inv_impl=impl)
                out[impl] = (f, jtri.block_thomas_substitute_partitioned(
                    f, b))
            return out
        want = _jit(ref)(jnp.asarray(a), jnp.asarray(u), jnp.asarray(b))
    for impl in ("lax", "blocked"):
        _close(x, want[impl][1])
    for g, w in zip(_fields(fac), _fields(want["lax"][0])):
        assert g.shape == w.shape
        _close(g, w)


def test_refusals(rng):
    a, u, _ = (_t(v) for v in _chain(rng, 24, 5))
    with pytest.raises(ValueError, match="not a multiple"):
        ttri.block_thomas_factor_partitioned(a, u, 7)
    with pytest.raises(ValueError, match="m=1 < 2"):
        ttri.block_thomas_factor_partitioned(a, u, 24)
    with pytest.raises(ValueError, match="blocked"):
        ttri.block_thomas_factor_partitioned(a, u, 4, inv_impl="blocked")
    with pytest.raises(ValueError, match="unknown inv_impl"):
        ttri.block_thomas_factor_partitioned(a, u, 4, inv_impl="newton")


def test_not_positive_definite_gives_nan_per_chunk(rng):
    """Only the chunk whose Schur complement is not PD gets a NaN
    inverse, as JAX's batched Cholesky gives it."""
    a, u, _ = _chain(rng, 24, 5)
    a[7] = -np.eye(5)  # chunk 1 of 4, interior block 1
    fac = ttri.block_thomas_factor_partitioned(_t(a), _t(u), 4)
    with _x64():
        jfac = _jit(jtri.block_thomas_factor_partitioned, 2)(
            jnp.asarray(a), jnp.asarray(u), 4)
    invs = fac.chunk.invs.numpy()
    np.testing.assert_array_equal(np.isnan(invs),
                                  np.isnan(np.asarray(jfac.chunk.invs)))
    assert np.isnan(invs[1:, 1]).all() and np.isfinite(invs[:, 0]).all()
    assert np.isfinite(invs[:, 2:]).all()


def test_flat_factor_pads_to_parts_and_matches_jax(rng):
    """``banded_factor_tridiag_flat(n_parts=3)``: 29 poses padded to a
    multiple of S * C = 12 (36: nine super-blocks, three a chunk); its
    resolve against the sequential factor's and against JAX's."""
    t1, band, s, c = 29, 4, 4, 3
    h_flat, b = _random_flat(rng, t1, band)
    fac = ttri.banded_factor_tridiag_flat(_t(h_flat), band, s, n_parts=c)
    assert fac.s.shape == (3, 36)
    assert isinstance(fac.factor, ttri.PartitionedThomasFactor)
    assert fac.factor.chunk.invs.shape == (2, c, 3 * s, 3 * s)
    x = ttri.banded_resolve_tridiag_flat(fac, _t(b), s)
    seq = ttri.banded_factor_tridiag_flat(_t(h_flat), band, s)
    assert seq.s.shape == (3, 32)
    _close(x, ttri.banded_resolve_tridiag_flat(seq, _t(b), s).numpy(),
           rtol=1e-12)
    with _x64():
        def ref(h, b):
            f = jtri.banded_factor_tridiag_flat(h, band, s, n_parts=c)
            return f, jtri.banded_resolve_tridiag_flat(f, b, s)
        jfac, want = _jit(ref)(jnp.asarray(h_flat), jnp.asarray(b))
    _close(fac.s, jfac.s)
    for g, w in zip(_fields(fac.factor), _fields(jfac.factor)):
        _close(g, w)
    _close(x, want)


@pytest.fixture(scope="module")
def scene():
    """The JAX package's 100-pose scene (key 3) and JAX's float64 GN
    solve of it with ``n_parts=4`` (S = 20: 100 poses padded to 160,
    eight super-blocks, two a chunk)."""
    out = jax_scene()
    out["want64"] = jax_gn(out, {"p4": {"n_parts": 4}}, x64=True)["p4"]
    return out


def test_partitioned_gn_float64_matches_jax(scene):
    cfg, po, obs, el, kw = _port_args(scene, torch.float64)
    got = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                   n_parts=4, **kw)
    want = scene["want64"]
    assert int(got.gn_iters) == int(want.gn_iters)
    _close(got.poses, want.poses)
    _close(got.delta_sum, want.delta_sum, rtol=1e-6)


def test_partitioned_gn_matches_sequential(scene):
    """``TestTridiagSolver.test_partitioned_gn_matches_sequential``: the
    float32 partitioned GN lands on the sequential one's poses; without
    the reuse path ``n_parts`` raises."""
    cfg, po, obs, el, kw = _port_args(scene, torch.float32)
    r_seq = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                     **kw)
    r_par = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                     n_parts=4, **kw)
    assert int(r_par.gn_iters) >= 1
    np.testing.assert_allclose(r_par.poses.numpy(), r_seq.poses.numpy(),
                               atol=5e-3)
    with pytest.raises(ValueError, match="n_parts"):
        tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                 n_parts=4, reuse_factorization=False, **kw)
