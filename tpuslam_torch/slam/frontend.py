"""Graph-SLAM simulation frontend: the reference ``Robot`` as scans, on
tensors, optionally batched over seeds.

Port of ``tpuslam/slam/frontend.py`` (reference: ``Robot``,
graph_based_slam.py:584-896, without the drawing): drive the true pose
with the noisy velocity motion model, keep a one-step noiseless odometry
guess as the graph's initial estimate, scan the landmarks at the true
pose every step, and each frame run Gauss-Newton over everything
observed so far.

Reference subtleties kept: the odometry guess for time t is one
noiseless step from the previous *true* pose (graph_based_slam.py:647-648,
656); time 0 scans from the exact start pose, which is also the
estimator's pose 0; estimates persist across frames, and time t enters
with its odometry value.

The JAX package's two ``lax.scan``s are Python loops here: the motion
chain a step at a time (the scans and odometry guesses of every time at
once after it), the frames one at a time.  ``seeds=B`` adds a leading
seed axis to every result: the torch form of ``jax.vmap`` over keys, the
B courses drawing their noise from the one generator.  JAX's key splits
cannot be reproduced, so :func:`simulate_with_noise` takes the normals
from the caller and :func:`simulate` draws them and calls it.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from tpuslam_torch.models.motion import (MotionConfig, motion_mean,
                                         motion_sample_with_noise)
from tpuslam_torch.models.scan_sensor import (ScanConfig, scan_apply_noise,
                                              scan_true)
from tpuslam_torch.slam.graph import (GraphConfig, GraphObservations,
                                      GraphSolveResult, graph_solve)

#: Reference demo landmark table (graph_based_slam.py:910-918).
REF_SLAM_LANDMARKS = ((0.0, 0.0), (14.0, 1.0), (9.0, 9.0), (0.0, 15.0),
                      (-11.0, 10.0), (-14.0, 1.0), (-10.0, -9.0),
                      (0.0, -16.0), (10.0, -11.0))


@dataclasses.dataclass(frozen=True)
class SlamSceneConfig:
    """Static scenario config; field for field the JAX package's
    ``SlamSceneConfig`` (reference demo, graph_based_slam.py:900-927)."""

    landmarks: tuple = REF_SLAM_LANDMARKS
    dt: float = 2.0  # PERIOD_ms = 2000 (:921)
    radius_m: float = 10.0  # (:903)
    yaw_rate: float = math.radians(10.0)  # OMEGA_rps (:906)
    x0: tuple = (10.0, 0.0, math.pi / 2.0)  # x_base (:923-925)
    motion: MotionConfig = MotionConfig(dt=2.0)  # a1..a6 = 0.1 (:605)

    @property
    def vel(self) -> float:
        return self.radius_m * self.yaw_rate  # VEL_mps (:907)


class SlamTrajectory(typing.NamedTuple):
    """Padded simulation results; row t = time t (row 0 = start)."""

    poses_actu: torch.Tensor  # (..., T1, 3) ground truth
    poses_odom: torch.Tensor  # (..., T1, 3) one-step noiseless guesses
    obs: GraphObservations  # (..., T1, L) noisy sightings
    obs_true: GraphObservations  # (..., T1, L) noise-free sightings


def reference_course_config(n_steps: int, guard: str = "full",
                            **overrides) -> GraphConfig:
    """The :class:`GraphConfig` of the reference demo course:
    ``max_times = n_steps + 1`` over the 9 demo landmarks with the demo's
    scan noise (15 m / 80 deg FOV, 5% range noise, 2 deg bearing and
    orientation; graph_based_slam.py:604, 900-927)."""
    kw = dict(
        max_times=n_steps + 1, num_landmarks=len(REF_SLAM_LANDMARKS),
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)),
        guard=guard)
    kw.update(overrides)
    return GraphConfig(**kw)


def _constant(values, dtype, device) -> torch.Tensor:
    """Python ``values`` on ``device`` with no host synchronisation."""
    # ops imports the filters, which import models: imported at call time.
    from tpuslam_torch.ops._build import device_constant

    return device_constant(values, torch.empty(0, dtype=dtype, device=device))


def _controls(scene: SlamSceneConfig, n_steps: int, controls, device):
    """``(n_steps, 2)`` float32 ``(v, w)`` commands: the caller's, or the
    demo's constant circle (graph_based_slam.py:941)."""
    if controls is None:
        return _constant([(scene.vel, scene.yaw_rate)], torch.float32,
                         device).expand(n_steps, 2)
    controls = torch.as_tensor(controls, dtype=torch.float32, device=device)
    if tuple(controls.shape) != (n_steps, 2):
        raise ValueError(
            f"controls shape {tuple(controls.shape)} != ({n_steps}, 2)")
    return controls


def simulate_with_noise(scene: SlamSceneConfig, graph_cfg: GraphConfig,
                        motion_noise: torch.Tensor, scan_noise: torch.Tensor,
                        controls=None) -> SlamTrajectory:
    """Simulate from the caller's standard normals: ``motion_noise``
    ``(..., n_steps, 3)`` for each step's (v, w, gamma) draws and
    ``scan_noise`` ``(..., n_steps + 1, L, 3)`` for each time's sightings
    (row 0 the start pose's scan).  Runs on the noise's device and dtype.
    """
    dtype, device = motion_noise.dtype, motion_noise.device
    n_steps = motion_noise.shape[-2]
    lead = motion_noise.shape[:-2]
    ctl = _controls(scene, n_steps, controls, device)
    lm = _constant(scene.landmarks, dtype, device)
    x0 = _constant(scene.x0, dtype, device).expand(lead + (3,))

    pose = x0
    actu = [x0]
    for k in range(n_steps):
        pose = motion_sample_with_noise(scene.motion, pose, ctl[k, 0],
                                        ctl[k, 1], motion_noise[..., k, :])
        actu.append(pose)
    poses_actu = torch.stack(actu, dim=-2)
    odom = motion_mean(scene.motion, poses_actu[..., :-1, :], ctl[:, 0],
                       ctl[:, 1])
    poses_odom = torch.cat([x0[..., None, :], odom], dim=-2)
    true = scan_true(graph_cfg.scan, poses_actu, lm)
    noisy = scan_apply_noise(graph_cfg.scan, true, scan_noise)
    return SlamTrajectory(poses_actu=poses_actu, poses_odom=poses_odom,
                          obs=GraphObservations(*noisy),
                          obs_true=GraphObservations(*true))


def simulate(scene: SlamSceneConfig, graph_cfg: GraphConfig,
             generator: torch.Generator, n_steps: int, controls=None, *,
             device: torch.device | str,
             seeds: int | None = None) -> SlamTrajectory:
    """Simulate ``n_steps`` frames of motion and scanning
    (``Robot.move`` and ``Robot.__observe``, graph_based_slam.py:638-682)
    on ``device``, one course or ``seeds`` of them, the normals drawn from
    ``generator`` (motion first, then scans) in float32.

    ``controls``: optional ``(n_steps, 2)`` per-step ``(v, w)`` commands;
    default the demo's constant circle.
    """
    from tpuslam_torch.filters.pf import check_generator

    device = check_generator(generator, device)
    lead = () if seeds is None else (seeds,)
    num_l = len(scene.landmarks)
    motion_noise = torch.randn(lead + (n_steps, 3), generator=generator,
                               device=device)
    scan_noise = torch.randn(lead + (n_steps + 1, num_l, 3),
                             generator=generator, device=device)
    return simulate_with_noise(scene, graph_cfg, motion_noise, scan_noise,
                               controls=controls)


def observed_times_mask(obs: GraphObservations) -> torch.Tensor:
    """Boolean ``(..., T1)`` of times whose scan saw a landmark, time 0
    always (``isObs``, graph_based_slam.py:343, 674-682)."""
    mask = obs.valid.any(dim=-1)
    mask[..., 0] = True
    return mask


def estimate_frames(graph_cfg: GraphConfig, traj: SlamTrajectory):
    """Per-frame Gauss-Newton over a simulated trajectory: frame t solves
    times 0..t from the previous frame's estimates.

    Returns ``(poses_est, frames)``: the final ``(..., T1, 3)`` estimates
    and a :class:`GraphSolveResult` whose fields have a frame axis after
    any seed axis (``poses`` emptied).
    """
    poses = traj.poses_odom
    n_steps = poses.shape[-2] - 1
    lead = poses.shape[:-2]
    frames = []
    for t in range(1, n_steps + 1):
        res = graph_solve(graph_cfg, poses, traj.obs, t_now=t)
        poses = res.poses
        frames.append(res)
    axis = len(lead)
    stacked = GraphSolveResult(*(
        torch.stack(field, dim=axis) for field in zip(*frames)))
    empty = poses.new_zeros(lead + (n_steps, 0))
    return poses, stacked._replace(poses=empty)


def slam_rollout(scene: SlamSceneConfig, graph_cfg: GraphConfig,
                 generator: torch.Generator, n_steps: int, controls=None, *,
                 device: torch.device | str, seeds: int | None = None):
    """Simulate, then estimate frame by frame (the reference's animation
    callback, graph_based_slam.py:931-975).

    Returns ``(traj, poses_est, frames)``: the :class:`SlamTrajectory`,
    the final ``(..., T1, 3)`` estimates and the per-frame
    :class:`GraphSolveResult` (is_calc, gn_iters, delta_sum, det, cond and
    the ``max_gn_iters`` traces of every frame; ``poses`` emptied).
    """
    traj = simulate(scene, graph_cfg, generator, n_steps, controls,
                    device=device, seeds=seeds)
    poses_est, frames = estimate_frames(graph_cfg, traj)
    return traj, poses_est, frames


def solve_once(scene: SlamSceneConfig, graph_cfg: GraphConfig,
               generator: torch.Generator, n_steps: int, controls=None, *,
               device: torch.device | str, seeds: int | None = None):
    """Simulate, then one full-history Gauss-Newton solve; returns
    ``(traj, result)``."""
    traj = simulate(scene, graph_cfg, generator, n_steps, controls,
                    device=device, seeds=seeds)
    return traj, graph_solve(graph_cfg, traj.poses_odom, traj.obs)
