"""The port's metrics against the JAX package on the same random inputs.

Tolerance: 1e-5 relative in float32 (reductions run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.metrics as jm
import tpuslam_torch.metrics as tm


@pytest.fixture
def rollouts(rng):
    est = rng.normal(size=(4, 10, 3)).astype(np.float32)
    truth = (est + rng.normal(size=est.shape) * 0.5).astype(np.float32)
    a = rng.normal(size=(4, 10, 3, 3)) * 0.3
    cov = (a @ np.swapaxes(a, -1, -2) + np.eye(3) * 0.2).astype(np.float32)
    return est, truth, cov


def _both(name, *arrays, **kw):
    got = getattr(tm, name)(*map(torch.from_numpy, arrays), **kw)
    want = getattr(jm, name)(*map(jnp.asarray, arrays), **kw)
    return got, want


@pytest.mark.parametrize("name,kw", [
    ("position_rmse", {}), ("position_rmse", {"axis": -1}),
    ("yaw_rmse", {}), ("yaw_rmse", {"axis": -1}),
])
def test_rmse_matches_jax(rollouts, name, kw):
    got, want = _both(name, *rollouts[:2], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("dims", [2, 3])
def test_nees_matches_jax(rollouts, dims):
    got, want = _both("nees", *rollouts, dims=dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    got, want = _both("nees_consistency", *rollouts, dims=dims, axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_divergence_mask_matches_jax(rollouts):
    est, truth, _ = rollouts
    est = est.copy()
    est[1, 3, 0] = 1e3
    est[2, 5, 1] = np.nan
    got, want = _both("divergence_mask", est, truth, threshold=2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1] and not got[2]


def test_summarize_matches_jax(rollouts):
    got, want = _both("summarize_rollouts", *rollouts)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert "mean_nees" not in tm.summarize_rollouts(
        *map(torch.from_numpy, rollouts[:2]))
