"""Sector-FOV landmark scan sensor, fixed-shape and masked, on tensors.

Port of ``tpuslam/models/scan_sensor.py`` (reference: ``ScanSensor``,
graph_based_slam.py:73-259): range, bearing and orientation of every
landmark, with a sector field of view about the robot's forward axis,
range-proportional distance noise and Gaussian bearing/orientation noise.
"Orientation" is the heading of the world +y axis in the robot frame,
``BASE_ANG - yaw`` (graph_based_slam.py:153).

Every scan returns ``(..., L)`` tensors for all landmarks and a boolean
``valid`` mask in place of the reference's variable-length lists.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.core.se2 import BASE_ANG, world_to_robot


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Static scan-sensor configuration; field for field the JAX
    package's ``ScanConfig`` (reference class defaults,
    graph_based_slam.py:78-81)."""

    range_m: float = 15.0
    angle_rad: float = math.radians(80.0)
    #: distance noise std = dist * dist_gain (graph_based_slam.py:79,165)
    dist_gain: float = 10.0 / 100.0
    dir_sigma: float = math.radians(3.0)
    orient_sigma: float = math.radians(3.0)


class Scan(typing.NamedTuple):
    """Fixed-shape scan result; each field is ``(..., L)``."""

    dist: torch.Tensor
    bearing: torch.Tensor
    orient: torch.Tensor
    valid: torch.Tensor  # bool; False entries are geometric truth w/o noise


def scan_true(cfg: ScanConfig, pose, landmarks) -> Scan:
    """Noise-free scan of every landmark from ``(..., 3)`` poses
    (graph_based_slam.py:150-160): landmark i is valid iff
    ``dist_i <= range`` and ``y_i >= |x_i| tan(BASE_ANG - scan_angle)``
    in the robot frame.  ``landmarks`` is ``(L, 2)``."""
    landmarks = torch.as_tensor(landmarks, dtype=pose.dtype,
                                device=pose.device)
    lm_r = world_to_robot(pose, landmarks)  # (..., L, 2)
    x, y = lm_r[..., 0], lm_r[..., 1]
    dist = torch.sqrt(x * x + y * y)
    bearing = torch.atan2(y, x)
    orient = (wrap_angle(BASE_ANG - pose[..., 2])[..., None]
              * torch.ones_like(x))
    sector = y >= x.abs() * math.tan(BASE_ANG - cfg.angle_rad)
    valid = (dist <= cfg.range_m) & sector
    return Scan(dist, bearing, orient, valid)


def scan(cfg: ScanConfig, generator: torch.Generator, pose, landmarks):
    """Noisy and noise-free scans ``(noisy, true)`` sharing one ``valid``
    mask (graph_based_slam.py:128-172); three normals a landmark from
    ``generator``, which must lie on the pose's device."""
    from tpuslam_torch.filters.pf import check_generator

    check_generator(generator, pose.device)
    true = scan_true(cfg, pose, landmarks)
    n = torch.randn(true.dist.shape + (3,), generator=generator,
                    dtype=true.dist.dtype, device=true.dist.device)
    return scan_apply_noise(cfg, true, n), true


def scan_apply_noise(cfg: ScanConfig, true: Scan, unit_noise) -> Scan:
    """The reference's sighting noise law (graph_based_slam.py:164-167)
    on a noise-free scan, with ``(..., L, 3)`` standard-normal draws for
    (dist, bearing, orient)."""
    n = unit_noise
    dist_n = true.dist + n[..., 0] * true.dist * cfg.dist_gain
    bear_n = wrap_angle(true.bearing + n[..., 1] * cfg.dir_sigma)
    orient_n = wrap_angle(true.orient + n[..., 2] * cfg.orient_sigma)
    return Scan(dist_n, bear_n, orient_n, true.valid)


def measurement_cov(cfg: ScanConfig, dist):
    """``(..., 3, 3)`` diagonal sighting covariances in the measurement
    frame (graph_based_slam.py:175-194):
    diag((d gain)^2, (d sin(dir_sigma))^2, dir_sigma^2 + orient_sigma^2)."""
    dd = torch.square(dist * cfg.dist_gain)
    dc = torch.square(dist * math.sin(cfg.dir_sigma))
    oc = torch.full_like(dist, cfg.dir_sigma ** 2 + cfg.orient_sigma ** 2)
    z = torch.zeros_like(dist)
    return torch.stack([
        torch.stack([dd, z, z], dim=-1),
        torch.stack([z, dc, z], dim=-1),
        torch.stack([z, z, oc], dim=-1),
    ], dim=-2)


@highest_matmul_precision
def _rot_z_cov(cov, ang):
    """Rotate ``(..., 3, 3)`` covariances about z by ``ang``."""
    c, s = torch.cos(ang), torch.sin(ang)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rot = torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return torch.einsum("...ij,...jk,...lk->...il", rot, cov, rot)


def cov_measurement_to_world(cov, lm_bearing, robot_yaw):
    """Measurement-frame covariance into the world frame, by
    bearing + yaw - BASE_ANG (graph_based_slam.py:196-215)."""
    return _rot_z_cov(cov, lm_bearing + robot_yaw - BASE_ANG)


def cov_measurement_to_robot(cov, lm_bearing):
    """Measurement-frame covariance into the robot frame, by the bearing
    (graph_based_slam.py:218-234)."""
    return _rot_z_cov(cov, lm_bearing)
