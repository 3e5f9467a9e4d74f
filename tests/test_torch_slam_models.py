"""Graph SLAM's supporting models in the port against the JAX package and
the float64 oracles: chi-squared quantiles, error ellipses, the velocity
motion model and the scan sensor, and the four configs copied field for
field.

Inputs come from numpy with a fixed seed.  Tolerances: 1e-5 against the
JAX package in float32 (the same formulas; the libraries' trig and
division differ by rounding), 1e-10 against the oracles in float64;
ellipse angles compare modulo pi (eigenvector signs differ between
LAPACK builds), at 1e-4 as ``tests/test_core.py`` holds them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
import tpuslam.core.chi2 as jchi2
import tpuslam.core.ellipse as jell
import tpuslam.models.motion as jmo
import tpuslam.models.scan_sensor as jsc
import tpuslam.slam as jslam
import tpuslam_torch.core as tcore
import tpuslam_torch.models as tmod
import tpuslam_torch.slam as tslam
from tpuslam_torch.convert import (graph_config_from, motion_config_from,
                                   scan_config_from, slam_scene_config_from)

LMS = np.array(jslam.REF_SLAM_LANDMARKS)
MCFG = tmod.MotionConfig(dt=1.0, a1=0.05, a2=0.05, a3=0.01, a4=0.01,
                         a5=0.01, a6=0.01)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("pair", [
    (tmod.MotionConfig(dt=2.0), jmo.MotionConfig(dt=2.0), motion_config_from),
    (tmod.ScanConfig(), jsc.ScanConfig(), scan_config_from),
    (tslam.reference_course_config(18), jslam.reference_course_config(18),
     graph_config_from),
    (tslam.GraphConfig(max_times=5, num_landmarks=3),
     jslam.GraphConfig(max_times=5, num_landmarks=3), graph_config_from),
    (tslam.SlamSceneConfig(), jslam.SlamSceneConfig(),
     slam_scene_config_from),
], ids=["motion", "scan", "course", "graph", "scene"])
def test_configs_equal_jax(pair):
    ported, ref, conv = pair
    assert conv(ref) == ported
    for field in ported.__dataclass_fields__:
        got, want = getattr(ported, field), getattr(ref, field)
        if hasattr(want, "__dataclass_fields__"):
            got, want = tuple(vars(got).values()), tuple(vars(want).values())
        assert got == want, field
    assert tslam.REF_SLAM_LANDMARKS == jslam.REF_SLAM_LANDMARKS


def test_scene_vel_and_damping_check():
    assert tslam.SlamSceneConfig().vel == jslam.SlamSceneConfig().vel
    with pytest.raises(ValueError, match="damping"):
        tslam.GraphConfig(max_times=3, num_landmarks=1, damping=-0.1)


def test_chi2_grid_equals_jax():
    assert tcore.chi2.P_GRID == jchi2.P_GRID
    assert tcore.chi2.CHI2_GRID == jchi2.CHI2_GRID


def test_chi2_matches_jax_f32(rng):
    # In and beyond the grid (both ends clamp), grid points included.
    p = np.concatenate([rng.uniform(-5.0, 105.0, 400), [0.0, 50.0, 99.9,
                                                        99.95, 100.0]])
    p32 = p.astype(np.float32)
    got = tcore.chi2_ppf_2dof_table(_t(p32)).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jchi2.chi2_ppf_2dof_table(p32)), rtol=1e-5, atol=1e-5)
    q = p32[(p32 >= 0) & (p32 < 99.99)]
    np.testing.assert_allclose(tcore.chi2_ppf_2dof(_t(q)).numpy(),
                               np.asarray(jchi2.chi2_ppf_2dof(q)),
                               rtol=1e-5)
    # Python scalars, as the renderer calls them.
    assert math.isclose(float(tcore.chi2_ppf_2dof_table(98.75)),
                        float(jchi2.chi2_ppf_2dof_table(98.75)),
                        rel_tol=1e-6)


def test_chi2_f64_matches_closed_form(rng):
    p = rng.uniform(0.0, 99.9, 300)
    got = tcore.chi2_ppf_2dof(_t(p)).numpy()
    np.testing.assert_allclose(got, -2.0 * np.log1p(-p / 100.0), atol=1e-10)
    # On the grid the table is the closed form.
    grid = np.array(tcore.chi2.P_GRID)
    np.testing.assert_allclose(tcore.chi2_ppf_2dof_table(_t(grid)).numpy(),
                               tcore.chi2.CHI2_GRID, atol=1e-10)


def _angles_mod_pi(got, want, tol):
    d = np.mod(got - want, np.pi)
    np.testing.assert_array_less(np.minimum(d, np.pi - d), tol)


@pytest.mark.parametrize("row", [True, False])
def test_error_ellipse_matches_jax(rng, row):
    a = rng.normal(size=(64, 2, 2))
    sig = (a @ np.swapaxes(a, -1, -2) + np.eye(2) * 0.1).astype(np.float32)
    got = tcore.error_ellipse(_t(sig), 99.0, row_eigvec_compat=row)
    want = jell.error_ellipse(jnp.asarray(sig), 99.0, row_eigvec_compat=row)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    _angles_mod_pi(got[2].numpy(), np.asarray(want[2]), 1e-4)
    np.testing.assert_allclose(
        tcore.major_axis_length(_t(sig), 95.0).numpy(),
        np.asarray(jell.major_axis_length(jnp.asarray(sig), 95.0)),
        rtol=1e-5)


def test_error_ellipse_f64_matches_numpy(rng):
    for _ in range(10):
        a = rng.normal(size=(2, 2))
        sigma = a @ a.T + np.eye(2) * 0.1
        val, vec = np.linalg.eigh(sigma)
        chi2 = -2.0 * math.log1p(-0.99)
        major, minor, ang = tcore.error_ellipse(_t(sigma), 99.0)
        assert math.isclose(float(major), 2 * math.sqrt(val[1] * chi2),
                            rel_tol=1e-10)
        assert math.isclose(float(minor), 2 * math.sqrt(val[0] * chi2),
                            rel_tol=1e-10)
        _angles_mod_pi(np.array([float(ang)]),
                       np.array([np.arctan2(vec[1][1], vec[1][0])]), 1e-10)


@pytest.mark.parametrize("sq,guard", [(True, True), (False, True),
                                      (True, False), (False, False)])
def test_motion_with_noise_matches_jax(rng, sq, guard):
    tcfg = tmod.MotionConfig(dt=2.0, sigma_squared_std=sq, omega_guard=guard)
    jcfg = jmo.MotionConfig(dt=2.0, sigma_squared_std=sq, omega_guard=guard)
    pose = (rng.normal(size=(32, 3)) * [5.0, 5.0, 2.0]).astype(np.float32)
    v = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, 32).astype(np.float32)
    n = rng.normal(size=(32, 3)).astype(np.float32)
    got = tmod.motion_sample_with_noise(tcfg, _t(pose), _t(v), _t(w), _t(n))
    want = jmo.motion_sample_with_noise(jcfg, pose, v, w, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got_m = tmod.motion_mean(tcfg, _t(pose), _t(v), _t(w))
    want_m = jmo.motion_mean(jcfg, pose, v, w)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)


def test_motion_f64_matches_oracle(rng):
    a = (MCFG.a1, MCFG.a2, MCFG.a3, MCFG.a4, MCFG.a5, MCFG.a6)
    for _ in range(8):
        pose = rng.normal(size=3)
        v, w = rng.uniform(0.5, 2.0), rng.uniform(0.2, 1.0)
        n = rng.normal(size=3)
        got = tmod.motion_sample_with_noise(MCFG, _t(pose), v, w, _t(n))
        np.testing.assert_allclose(
            got.numpy(), oracles.motion_with_noise(pose, v, w, 1.0, a, n),
            atol=1e-10)
        got_m = tmod.motion_mean(MCFG, _t(pose), v, w)
        np.testing.assert_allclose(
            got_m.numpy(), oracles.motion_without_noise(pose, v, w, 1.0),
            atol=1e-10)


def test_motion_straight_line_at_w_zero():
    pose = torch.tensor([1.0, 2.0, 0.3], dtype=torch.float64)
    on = tmod.motion_mean(tmod.MotionConfig(dt=2.0), pose, 1.5, 0.0)
    want = np.asarray(jmo.motion_mean(jmo.MotionConfig(dt=2.0),
                                      jnp.asarray(pose.numpy()), 1.5, 0.0))
    np.testing.assert_allclose(on.numpy(), [1.0 + 3.0 * math.cos(0.3),
                                            2.0 + 3.0 * math.sin(0.3), 0.3],
                               atol=1e-12)
    np.testing.assert_allclose(on.numpy(), want, atol=1e-6)
    # A tensor w of exact zeros takes the same straight line, and the
    # guard changes nothing where w != 0.
    w = torch.tensor([0.0, 0.7], dtype=torch.float64)
    both = tmod.motion_mean(tmod.MotionConfig(dt=2.0), pose, 1.5, w)
    assert torch.isfinite(both).all()
    np.testing.assert_allclose(both[0].numpy(), on.numpy(), atol=1e-12)
    off = tmod.motion_mean(tmod.MotionConfig(dt=2.0, omega_guard=False),
                           pose, 1.5, 0.7)
    np.testing.assert_allclose(both[1].numpy(), off.numpy(), atol=1e-12)


def test_motion_guard_off_divides_by_zero():
    cfg = tmod.MotionConfig(dt=1.0, omega_guard=False)
    pose = torch.zeros(3)
    with pytest.raises(ZeroDivisionError):
        tmod.motion_mean(cfg, pose, 1.0, 0.0)
    out = tmod.motion_mean(cfg, pose, torch.tensor(1.0), torch.tensor(0.0))
    assert not torch.isfinite(out[:2]).all()


def test_motion_sample_draws_from_generator():
    pose = torch.tensor([[10.0, 0.0, math.pi / 2]] * 4)
    got = tmod.motion_sample(MCFG, torch.Generator().manual_seed(9), pose,
                             1.7, 0.17)
    n = torch.randn((4, 3), generator=torch.Generator().manual_seed(9))
    want = tmod.motion_sample_with_noise(MCFG, pose, 1.7, 0.17, n)
    assert torch.equal(got, want)
    assert got.shape == (4, 3) and not torch.equal(got[0], got[1])


def test_scan_matches_jax(rng):
    tcfg, jcfg = tmod.ScanConfig(), jsc.ScanConfig()
    poses = (rng.normal(size=(40, 3)) * [6.0, 6.0, 3.0]).astype(np.float32)
    lms = LMS.astype(np.float32)
    got = tmod.scan_true(tcfg, _t(poses), _t(lms))
    want = jsc.scan_true(jcfg, poses, lms)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any() and not got.valid.all()
    n = rng.normal(size=(40, 9, 3)).astype(np.float32)
    noisy = tmod.scan_apply_noise(tcfg, got, _t(n))
    want_n = jsc.scan_apply_noise(jcfg, want, n)
    for g, w in zip(noisy, want_n):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_scan_f64_matches_oracle(rng):
    cfg = tmod.ScanConfig()
    for _ in range(6):
        pose = rng.normal(size=3) * [6.0, 6.0, 3.0]
        got = tmod.scan_true(cfg, _t(pose), _t(LMS))
        dist, bearing, orient, valid = oracles.scan_true(
            pose, LMS, cfg.range_m, cfg.angle_rad)
        # The oracle leaves the orientation unwrapped.
        orient = np.array([oracles.limit_angle(o) for o in orient])
        for g, w in zip(got[:3], (dist, bearing, orient)):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-10)
        np.testing.assert_array_equal(got.valid.numpy(), valid)


def test_scan_draws_from_generator():
    cfg = tmod.ScanConfig()
    pose = torch.tensor([[10.0, 0.0, math.pi / 2]] * 3)
    noisy, true = tmod.scan(cfg, torch.Generator().manual_seed(4), pose,
                            _t(LMS.astype(np.float32)))
    n = torch.randn((3, 9, 3), generator=torch.Generator().manual_seed(4))
    want = tmod.scan_apply_noise(cfg, true, n)
    for g, w in zip(noisy, want):
        assert torch.equal(g, w)
    assert torch.equal(noisy.valid, true.valid)


def test_measurement_cov_and_rotations(rng):
    cfg = tmod.ScanConfig()
    d = rng.uniform(1.0, 14.0, 16)
    got = tmod.measurement_cov(cfg, _t(d)).numpy()
    for k in range(16):
        np.testing.assert_allclose(got[k], oracles.measurement_cov(
            d[k], cfg.dist_gain, cfg.dir_sigma, cfg.orient_sigma),
            atol=1e-12)
    bear, yaw = rng.uniform(-3, 3, 16), rng.uniform(-3, 3, 16)
    w = tmod.cov_measurement_to_world(_t(got), _t(bear), _t(yaw)).numpy()
    r = tmod.cov_measurement_to_robot(_t(got), _t(bear)).numpy()
    for k in range(16):
        np.testing.assert_allclose(w[k], oracles.rot_z_cov(
            got[k], bear[k] + yaw[k] - oracles.BASE_ANG), atol=1e-12)
        np.testing.assert_allclose(r[k], oracles.rot_z_cov(got[k], bear[k]),
                                   atol=1e-12)
    # float32 against the JAX package.
    g32 = got.astype(np.float32)
    b32, y32 = bear.astype(np.float32), yaw.astype(np.float32)
    np.testing.assert_allclose(
        tmod.cov_measurement_to_world(_t(g32), _t(b32), _t(y32)).numpy(),
        np.asarray(jsc.cov_measurement_to_world(g32, b32, y32)), atol=1e-5)
    np.testing.assert_allclose(
        tmod.measurement_cov(cfg, _t(d.astype(np.float32))).numpy(),
        np.asarray(jsc.measurement_cov(jsc.ScanConfig(),
                                       d.astype(np.float32))), rtol=1e-5)
