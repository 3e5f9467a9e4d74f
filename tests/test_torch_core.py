"""The port's L0 math against the JAX package and the float64 oracles.

Inputs come from numpy with a fixed seed.  Tolerances: 1e-6 against the
JAX package in float32 (the same float32 formulas, so they differ only by
the libraries' rounding), 1e-10 against the numpy oracles in float64.
"""

import numpy as np
import pytest
import torch

import oracles
import tpuslam.core as jcore
import tpuslam_torch.core as tcore
from tpuslam_torch.core import highest_matmul_precision


def _off_boundary(angles):
    """Drop angles within rounding of an odd multiple of pi, where the two
    wrap conventions may land on opposite sides."""
    frac = np.abs(np.abs(angles) / np.pi % 2.0 - 1.0)
    return angles[frac > 1e-4]


@pytest.mark.parametrize("name", ["wrap_angle", "wrap_angle_fast"])
def test_wrap_matches_jax_f32(rng, name):
    angles = _off_boundary(rng.uniform(-12 * np.pi, 12 * np.pi, 4001))
    a32 = angles.astype(np.float32)
    got = getattr(tcore, name)(torch.from_numpy(a32)).numpy()
    want = np.asarray(getattr(jcore, name)(a32))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_wrap_matches_oracle_f64(rng):
    angles = _off_boundary(np.concatenate([
        rng.uniform(-12 * np.pi, 12 * np.pi, 2001),
        [7.5 * np.pi, -9.3 * np.pi, 100.0, -1000.0]]))
    got = tcore.wrap_angle(torch.from_numpy(angles)).numpy()
    want = np.array([oracles.limit_angle(a) for a in angles])
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_base_ang():
    assert tcore.BASE_ANG == float(jcore.BASE_ANG)


@pytest.mark.parametrize("name", ["world_to_robot", "robot_to_world"])
def test_se2_matches_jax_f32(rng, name):
    poses = rng.normal(size=(16, 3)).astype(np.float32)
    pts = rng.normal(size=(16, 5, 2)).astype(np.float32)
    got = getattr(tcore, name)(torch.from_numpy(poses),
                               torch.from_numpy(pts)).numpy()
    want = np.asarray(getattr(jcore, name)(poses, pts))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name,oracle", [
    ("world_to_robot", oracles.world2robot),
    ("robot_to_world", oracles.robot2world)])
def test_se2_matches_oracle_f64(rng, name, oracle):
    pose = rng.normal(size=3)
    pts = rng.normal(size=(7, 2)) * 10.0
    got = getattr(tcore, name)(torch.from_numpy(pose),
                               torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, oracle(pose, pts), atol=1e-10)


def test_se2_round_trip_broadcast(rng):
    poses = torch.from_numpy(rng.normal(size=(8, 3)))
    pts = torch.from_numpy(rng.normal(size=(5, 2)))
    robot = tcore.world_to_robot(poses, pts)
    assert robot.shape == (8, 5, 2)
    back = tcore.robot_to_world(poses, robot)
    np.testing.assert_allclose(back.numpy(), np.broadcast_to(
        pts.numpy(), (8, 5, 2)), atol=1e-12)


def test_precision_pinned_and_restored():
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        @highest_matmul_precision
        def inside():
            return (torch.get_float32_matmul_precision(),
                    torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)

        assert inside() == ("highest", False, False)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        torch.backends.cudnn.allow_tf32 = before[2]
