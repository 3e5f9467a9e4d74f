"""The port's process and observation models against the JAX package.

Tolerances: 1e-6 against the JAX package in float32, 1e-10 against the
numpy oracles and torch autodiff in float64.  Observation noise comes
from a ``torch.Generator``; the JAX side is fed the same draws.
"""

import numpy as np
import pytest
import torch

import oracles
import tpuslam.core as jcore
import tpuslam.models as jmodels
import tpuslam_torch.models as tmodels

V, W, DT = 1.7453292519943295, np.deg2rad(10.0), 0.1


def test_circular_step_matches_jax_f32(rng):
    poses = (rng.normal(size=(16, 3)) * [5.0, 5.0, 3.0]).astype(np.float32)
    got = tmodels.circular_step(torch.from_numpy(poses), V, W, DT).numpy()
    want = np.asarray(jmodels.circular_step(poses, V, W, DT))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_circular_step_matches_oracle_f64(rng):
    for x in rng.normal(size=(8, 3)):
        got = tmodels.circular_step(torch.from_numpy(x), V, W, DT).numpy()
        np.testing.assert_allclose(got, oracles.circular_step(x, V, W, DT),
                                   atol=1e-10)


def test_circular_jacobian_matches_jax_f32(rng):
    poses = rng.normal(size=(16, 3)).astype(np.float32)
    got = tmodels.circular_jacobian(torch.from_numpy(poses), V, DT).numpy()
    want = np.asarray(jmodels.circular_jacobian(poses, V, DT))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_circular_jacobian_matches_jacrev_f64(rng):
    x = torch.from_numpy(rng.normal(size=3))
    jac = tmodels.circular_jacobian(x, V, DT)
    # Away from the wrap boundary autodiff of the step equals the analytic
    # Jacobian (extended_kalman_filter.py:180-194).
    auto = torch.func.jacrev(lambda s: tmodels.circular_step(s, V, W, DT))(x)
    np.testing.assert_allclose(jac.numpy(), auto.numpy(), atol=1e-10)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-10)])
def test_position_observation_matches_jax(rng, dtype, atol):
    poses = rng.normal(size=(16, 3)) * [5.0, 5.0, 3.0]
    r_chol = np.array([[1.0, 0.0], [0.3, 0.8]])
    pose_t = torch.from_numpy(poses).to(dtype)
    got = tmodels.position_observation(
        torch.Generator().manual_seed(3), pose_t,
        torch.from_numpy(r_chol).to(dtype))
    # The same draws, rotated by the JAX package's transform.
    n = torch.randn((16, 2), generator=torch.Generator().manual_seed(3),
                    dtype=dtype).numpy()
    w = n @ r_chol.T
    if dtype == torch.float32:
        want = np.asarray(jcore.robot_to_world(
            poses.astype(np.float32), w[:, None, :].astype(np.float32)))
    else:
        want = np.stack([oracles.robot2world(p, wi[None])
                         for p, wi in zip(poses, w)])
    np.testing.assert_allclose(got.numpy(), want[:, 0, :], atol=atol)


def test_observations_zero_noise():
    pose = torch.tensor([3.0, -2.0, 0.7])
    z = tmodels.position_observation(torch.Generator().manual_seed(0), pose,
                                     torch.zeros(2, 2))
    np.testing.assert_allclose(z.numpy(), [3.0, -2.0], atol=1e-6)
    lms = np.array([[2.0, 3.0], [-1.0, 0.5]])
    pose64 = np.array([1.0, 1.0, 0.5])
    z = tmodels.landmark_observation(
        torch.Generator().manual_seed(0), torch.from_numpy(pose64),
        torch.from_numpy(lms), torch.zeros(2, 2, dtype=torch.float64))
    np.testing.assert_allclose(z.numpy(), oracles.world2robot(pose64, lms),
                               atol=1e-10)
