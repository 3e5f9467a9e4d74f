"""The port's shared PCG routine (``tpuslam_torch/core/pcg.py``) against
the JAX package's (``tpuslam/core/pcg.py``).

Both routines run the same matvec, preconditioner and dot on the same
float64 inputs: a 100-pose block-banded SPD system (300 unknowns, its
dense matrix and block-Jacobi preconditioner), the zero right-hand side,
an identity system and a semidefinite one.  They must give the same
iteration count and the same ``x`` to 1e-10 of its largest magnitude,
whatever the port's ``CHECK_EVERY`` (its host reads of the device-side
condition).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core.pcg import pcg as jpcg
from tpuslam_torch.core import pcg as tpcg

# The module itself: ``tpuslam_torch.core.pcg`` as an attribute is the
# function the package exports.
pcg_module = importlib.import_module("tpuslam_torch.core.pcg")

F64 = 1e-10
T1, BAND = 100, 3


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


def _system(seed=0):
    """A 100-pose banded SPD matrix (scalar bandwidth 3, block band 3),
    its 3x3 block-Jacobi inverse and a right-hand side."""
    rng = np.random.default_rng(seed)
    n = 3 * T1
    b_mat = rng.normal(size=(n, n)) * (
        np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3)
    a = b_mat @ b_mat.T + np.eye(n) * 0.5
    for i in range(T1):
        for j in range(T1):
            if abs(i - j) > BAND:
                a[3 * i:3 * i + 3, 3 * j:3 * j + 3] = 0
    a = 0.5 * (a + a.T) + np.eye(n) * 0.5
    minv = np.stack([np.linalg.inv(a[3 * i:3 * i + 3, 3 * i:3 * i + 3])
                     for i in range(T1)])
    return a, minv, rng.normal(size=(T1, 3))


def _jax_solve(a, minv, b, max_iters, tol):
    with _x64():
        ja, jm = jnp.asarray(a), jnp.asarray(minv)
        x, it = jax.jit(lambda b: jpcg(
            lambda x: (ja @ x.reshape(-1)).reshape(x.shape),
            lambda r: jnp.einsum("tij,tj->ti", jm, r),
            lambda p, q: jnp.sum(p * q), b, max_iters, tol))(jnp.asarray(b))
        return np.asarray(x), int(it)


def _port_solve(a, minv, b, max_iters, tol):
    ta, tm = torch.from_numpy(a), torch.from_numpy(minv)
    x, it = tpcg(lambda x: (ta @ x.reshape(-1)).reshape(x.shape),
                 lambda r: torch.einsum("tij,tj->ti", tm, r),
                 lambda p, q: torch.sum(p * q), torch.from_numpy(b),
                 max_iters, tol)
    assert it.dtype == torch.int32 and it.shape == ()
    return x.numpy(), int(it)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F64 * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def banded():
    a, minv, b = _system()
    return a, minv, b, {cap: _jax_solve(a, minv, b, cap, 1e-20)
                        for cap in (500, 7)}


@pytest.mark.parametrize("max_iters", [500, 7])
def test_banded_system_matches_jax(banded, max_iters):
    """Converged (500) and capped (7): the same ``x`` and iteration
    count as the JAX routine."""
    a, minv, b, want = banded
    x, it = _port_solve(a, minv, b, max_iters, 1e-20)
    assert it == want[max_iters][1]
    assert it == 7 if max_iters == 7 else 7 < it < max_iters
    _close(x, want[max_iters][0])
    if max_iters == 500:
        _close(x.reshape(-1), np.linalg.solve(a, b.reshape(-1)))


@pytest.mark.parametrize("check_every", [1, 5, 16, 1000])
def test_check_cadence_does_not_change_the_result(banded, monkeypatch,
                                                  check_every):
    """Iterations after the device-side condition fails leave the
    iterate and the count unchanged, however late the host reads it."""
    monkeypatch.setattr(pcg_module, "CHECK_EVERY", check_every)
    a, minv, b, want = banded
    x, it = _port_solve(a, minv, b, 500, 1e-20)
    assert it == want[500][1]
    _close(x, want[500][0])


def test_zero_rhs_short_circuits():
    """A negligible right-hand side gives zero and no iteration, as the
    JAX routine's ``lax.cond`` does."""
    eye = np.eye(24)
    minv = np.broadcast_to(np.eye(3), (8, 3, 3)).copy()
    b = np.zeros((8, 3))
    x, it = _port_solve(eye, minv, b, 50, 1e-8)
    jx, jit_ = _jax_solve(eye, minv, b, 50, 1e-8)
    assert it == jit_ == 0
    np.testing.assert_array_equal(x, 0.0)
    np.testing.assert_array_equal(jx, 0.0)
    # below the 1e-9 threshold, but not zero
    b[0, 0] = 1e-5
    x, it = _port_solve(eye, minv, b, 50, 1e-8)
    assert it == _jax_solve(eye, minv, b, 50, 1e-8)[1] == 0
    np.testing.assert_array_equal(x, 0.0)


def test_identity_system_converges_immediately():
    rng = np.random.default_rng(1)
    eye = np.eye(24)
    minv = np.broadcast_to(np.eye(3), (8, 3, 3)).copy()
    b = rng.normal(size=(8, 3))
    x, it = _port_solve(eye, minv, b, 50, 1e-10)
    jx, jit_ = _jax_solve(eye, minv, b, 50, 1e-10)
    assert it == jit_ and it <= 2
    _close(x, jx)
    np.testing.assert_allclose(x, b, atol=1e-12)


def test_semidefinite_direction_does_not_blow_up():
    """A matvec that kills one component (singular H) stops with finite
    output instead of dividing by ~0 curvature; the same as JAX."""
    mask = np.asarray([1.0, 1.0, 0.0])
    b = np.asarray([[1.0, 2.0, 3.0]])
    tmask = torch.from_numpy(mask)
    x, it = tpcg(lambda x: x * tmask, lambda r: r,
                 lambda p, q: torch.sum(p * q), torch.from_numpy(b), 50,
                 1e-12)
    with _x64():
        jmask = jnp.asarray(mask)
        jx, jit_ = jax.jit(lambda b: jpcg(
            lambda x: x * jmask, lambda r: r, lambda p, q: jnp.sum(p * q),
            b, 50, 1e-12))(jnp.asarray(b))
    assert np.isfinite(x.numpy()).all()
    assert int(it) == int(jit_)
    _close(x.numpy(), np.asarray(jx))


def test_non_finite_rhs_gives_zero():
    """A NaN right-hand side fails the ``bnorm`` test: zero and no
    iteration, in both routines."""
    eye = np.eye(24)
    minv = np.broadcast_to(np.eye(3), (8, 3, 3)).copy()
    b = np.ones((8, 3))
    b[3, 1] = np.nan
    x, it = _port_solve(eye, minv, b, 50, 1e-8)
    jx, jit_ = _jax_solve(eye, minv, b, 50, 1e-8)
    assert it == jit_ == 0
    np.testing.assert_array_equal(x, 0.0)
    np.testing.assert_array_equal(jx, 0.0)
