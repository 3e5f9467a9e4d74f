"""Dense graph SLAM in the port against the JAX package, the float64
oracles and the reference's statistical bands.

Every function meets the JAX package's on the same inputs: the JAX
package's own simulated course (6 frames, key 3), carried across as
numpy.  Tolerances: the float32 port against JAX at those of
``tests/test_graph.py`` (5e-3 on the poses after one iteration, 2e-2
after a full solve, 5% on the traces; 1e-4 relative on the edge blocks,
H and b, which are the same float32 formulas summed in another order);
the float64 port against ``tests/oracles.py`` at 1e-6 on the poses with
equal ``is_calc`` and ``gn_iters``.  A batched solve must give each seed
what its unbatched solve gives (equal ``is_calc`` and ``gn_iters``; the
values to float32 rounding, since batched and unbatched CPU kernels
round differently).  CPU tensors stay under torch's 32768-element
parallel grain (the band test runs its 64 seeds 16 at a time), and each
test runs on one torch thread: the batched 3x3 products split their
batch across threads whatever its size, which with six test workers on
eight cores oversubscribes them.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
import tpuslam.slam as jslam
import tpuslam.slam.graph as jgraph
import tpuslam_torch
import tpuslam_torch.slam as tslam
import tpuslam_torch.slam.graph as tgraph
from test_distributional import K_SIGMA, check
from tpuslam_torch.convert import (graph_config_from,
                                   graph_observations_from_numpy,
                                   slam_trajectory_from_numpy)

N = 6
T1 = N + 1
JCFG = jslam.reference_course_config(N)
TCFG = graph_config_from(JCFG)
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "ref_distributions.json"


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def course():
    """The JAX package's 6-frame course (key 3): its trajectory, final
    estimates and frames, as numpy."""
    out = jax.jit(lambda k: jslam.slam_rollout(
        jslam.SlamSceneConfig(), JCFG, k, N))(jax.random.key(3))
    return jax.tree_util.tree_map(np.array, out)


def _obs(traj, dtype=None):
    obs = graph_observations_from_numpy(traj.obs, device="cpu")
    if dtype is None:
        return obs
    return tslam.GraphObservations(*(t.to(dtype) for t in obs[:3]),
                                   obs.valid)


def _jobs(traj):
    return jslam.GraphObservations(*(jnp.asarray(a) for a in traj.obs))


def _oracle_args(traj):
    o = traj.obs
    return (np.asarray(o.dist, np.float64), np.asarray(o.bearing, np.float64),
            np.asarray(o.orient, np.float64), np.asarray(o.valid))


def _scan_args():
    sc = JCFG.scan
    return sc.dist_gain, sc.dir_sigma, sc.orient_sigma


def _close(got, want, rtol):
    """Arrays equal to ``rtol`` of the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_inv3x3_matches_jax_and_numpy(rng):
    m = rng.normal(size=(20, 3, 3))
    m = m @ np.swapaxes(m, -1, -2) + np.eye(3)
    got = tgraph._inv3x3(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, np.linalg.inv(m), atol=1e-10)
    m32 = m.astype(np.float32)
    np.testing.assert_allclose(
        tgraph._inv3x3(torch.from_numpy(m32)).numpy(),
        np.asarray(jgraph._inv3x3(jnp.asarray(m32))), rtol=1e-5, atol=1e-6)


def test_upper_pairs_match_jax():
    pi, pj = tslam.upper_pairs(T1)
    ji, jj = jslam.upper_pairs(T1)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pj.numpy(), np.asarray(jj))


@pytest.mark.parametrize("t_now", [1, 3, N])
def test_kept_times_match_jax(course, t_now):
    traj = course[0]
    got = tslam.kept_times(_obs(traj), t_now)
    want = jslam.kept_times(_jobs(traj), jnp.asarray(t_now))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _edges_both(traj, t_now):
    pi, pj = tslam.upper_pairs(T1)
    ji, jj = jslam.upper_pairs(T1)
    got = tslam.build_edges(TCFG, torch.from_numpy(traj.poses_odom),
                            _obs(traj), t_now, pi, pj)
    want = jslam.build_edges(JCFG, jnp.asarray(traj.poses_odom),
                             _jobs(traj), jnp.asarray(t_now), ji, jj)
    return got, want


@pytest.mark.parametrize("t_now", [3, N])
def test_build_edges_match_jax(course, t_now):
    got, want = _edges_both(course[0], t_now)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert got["mask"].any()
    for k in ("h_bb", "h_ba", "h_ab", "h_aa", "b_b", "b_a"):
        _close(got[k].numpy(), want[k], 1e-4)


def test_assemble_matches_jax_and_numpy_scatter(course):
    traj = course[0]
    kept = jslam.kept_times(_jobs(traj), jnp.asarray(N))
    _, want_edges = _edges_both(traj, N)
    ji, jj = jslam.upper_pairs(T1)
    want_h, want_b = jslam.assemble(JCFG, want_edges, kept, ji, jj, T1)
    pi, pj = tslam.upper_pairs(T1)
    edges = {k: torch.from_numpy(np.array(v))
             for k, v in want_edges.items()}
    kept_t = torch.from_numpy(np.array(kept))
    h, b = tslam.assemble(TCFG, edges, kept_t, pi, pj, T1)
    _close(h.numpy(), want_h, 1e-5)
    _close(b.numpy(), want_b, 1e-5)
    # float64 against a plain scatter-add in numpy.
    e64 = {k: v.double() if v.is_floating_point() else v
           for k, v in edges.items()}
    h64, b64 = tslam.assemble(TCFG, e64, kept_t, pi, pj, T1)
    h4 = np.zeros((T1, T1, 3, 3))
    b3 = np.zeros((T1, 3))
    ib, ia = np.repeat(pi.numpy(), 9), np.repeat(pj.numpy(), 9)
    fl = {k: v.reshape((-1,) + v.shape[2:]).numpy() for k, v in e64.items()}
    for rows, cols, key in ((ib, ib, "h_bb"), (ib, ia, "h_ba"),
                            (ia, ib, "h_ab"), (ia, ia, "h_aa")):
        np.add.at(h4, (rows, cols), fl[key])
    np.add.at(b3, ib, fl["b_b"])
    np.add.at(b3, ia, fl["b_a"])
    k = kept_t.numpy()
    first = int(np.argmax(k))
    for t in range(T1):
        h4[t, t] += np.eye(3) * ((0.0 if k[t] else 1.0)
                                 + (JCFG.anchor if t == first else 0.0))
    np.testing.assert_allclose(
        h64.numpy(), h4.transpose(0, 2, 1, 3).reshape(3 * T1, 3 * T1),
        rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(b64.numpy(), b3.reshape(-1), rtol=1e-12,
                               atol=1e-9)


def test_preconditioned_solve_ill_conditioned(rng):
    # Anchor-dominated system as in tests/test_graph.py: the
    # preconditioned float32 solve holds 1e-3 relative, and meets JAX's.
    n = 30
    a = rng.normal(size=(n, n))
    h = a @ a.T + np.eye(n)
    h[0:3, 0:3] += np.eye(3) * 1e4
    x_true = rng.normal(size=n)
    b = h @ x_true
    h32, b32 = h.astype(np.float32), b.astype(np.float32)
    got = tslam.preconditioned_solve(torch.from_numpy(h32),
                                     torch.from_numpy(b32)).numpy()
    assert np.linalg.norm(got - x_true) / np.linalg.norm(x_true) < 1e-3
    want = np.asarray(jslam.preconditioned_solve(jnp.asarray(h32),
                                                 jnp.asarray(b32)))
    _close(got, want, 1e-4)
    got64 = tslam.preconditioned_solve(torch.from_numpy(h),
                                       torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got64, x_true, atol=1e-9)


@pytest.mark.parametrize("guard", ["full", "cheap", "off"])
def test_guards_match_jax(course, guard):
    traj = course[0]
    jcfg = jslam.reference_course_config(N, guard=guard)
    tcfg = graph_config_from(jcfg)
    jkept = jslam.kept_times(_jobs(traj), jnp.asarray(N))
    _, want_edges = _edges_both(traj, N)
    ji, jj = jslam.upper_pairs(T1)
    h, _ = jslam.assemble(jcfg, want_edges, jkept, ji, jj, T1)
    want = jgraph._guards(jcfg, h, jkept)
    got = tgraph._guards(tcfg, torch.from_numpy(np.array(h)),
                         torch.from_numpy(np.array(jkept)))
    assert bool(got[0]) == bool(want[0])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-3)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3)


def test_gn_iteration_matches_jax_and_oracle(course):
    traj = course[0]
    pi, pj = tslam.upper_pairs(T1)
    ji, jj = jslam.upper_pairs(T1)
    got = tslam.gn_iteration(TCFG, torch.from_numpy(traj.poses_odom),
                             _obs(traj), N, pi, pj)
    want = jslam.gn_iteration(JCFG, jnp.asarray(traj.poses_odom),
                              _jobs(traj), jnp.asarray(N), ji, jj)
    assert bool(got[1]) == bool(want[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=5e-3)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=0.05,
                               atol=1e-4)

    p64 = np.asarray(traj.poses_odom, np.float64)
    got64 = tslam.gn_iteration(TCFG, torch.from_numpy(p64),
                               _obs(traj, torch.float64), N, pi, pj)
    o_poses, o_ok, o_delta, o_det, o_cond, _ = oracles.graph_gn_iteration(
        p64, *_oracle_args(traj), N, *_scan_args())
    assert bool(got64[1]) == o_ok
    np.testing.assert_allclose(got64[0].numpy(), o_poses, atol=1e-6)
    np.testing.assert_allclose(float(got64[2]), o_delta, rtol=1e-6)
    # det saturates at exp(+-80) (the clip that keeps it finite in f32).
    np.testing.assert_allclose(float(got64[3]),
                               np.exp(np.clip(np.log(o_det), -80.0, 80.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got64[4]), o_cond, rtol=1e-6)


def _check_traces(res, n_iters):
    for tr in (res.trace_delta_sum, res.trace_det, res.trace_cond):
        tr = tr.numpy()
        assert np.isfinite(tr[:n_iters]).all()
        assert np.isnan(tr[n_iters:]).all()


def test_graph_solve_matches_jax(course):
    traj = course[0]
    got = tslam.graph_solve(TCFG, torch.from_numpy(traj.poses_odom),
                            _obs(traj), t_now=N)
    want = jslam.graph_solve(JCFG, jnp.asarray(traj.poses_odom), _jobs(traj),
                             t_now=N)
    assert bool(got.is_calc) == bool(want.is_calc)
    assert int(got.gn_iters) == int(want.gn_iters)
    assert got.gn_iters.dtype == torch.int32
    n = int(got.gn_iters)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=2e-2)
    _check_traces(got, n)
    np.testing.assert_allclose(got.trace_delta_sum.numpy()[:n],
                               np.asarray(want.trace_delta_sum)[:n],
                               rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(np.log(got.trace_cond.numpy()[:n]),
                               np.log(np.asarray(want.trace_cond)[:n]),
                               rtol=0.05)


def test_graph_solve_f64_matches_oracle(course):
    traj = course[0]
    p64 = np.asarray(traj.poses_odom, np.float64)
    got = tslam.graph_solve(TCFG, torch.from_numpy(p64),
                            _obs(traj, torch.float64), t_now=N)
    o_poses, o_ok, o_delta, o_iters, o_trace = oracles.graph_solve(
        p64, *_oracle_args(traj), N, *_scan_args())
    assert bool(got.is_calc) == o_ok
    assert int(got.gn_iters) == o_iters
    np.testing.assert_allclose(got.poses.numpy(), o_poses, atol=1e-6)
    _check_traces(got, o_iters)
    o_ds, o_det, o_cond = (np.array(v) for v in zip(*o_trace))
    np.testing.assert_allclose(got.trace_delta_sum.numpy()[:o_iters], o_ds,
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(np.log(got.trace_det.numpy()[:o_iters]),
                               np.clip(np.log(o_det), -80.0, 80.0),
                               rtol=1e-6)
    np.testing.assert_allclose(got.trace_cond.numpy()[:o_iters], o_cond,
                               rtol=1e-6)


def test_frames_match_jax_rollout(course):
    traj, poses_est, frames = course
    poses, got = tslam.estimate_frames(
        TCFG, slam_trajectory_from_numpy(traj, device="cpu"))
    np.testing.assert_array_equal(got.is_calc.numpy(), frames.is_calc)
    np.testing.assert_array_equal(got.gn_iters.numpy(), frames.gn_iters)
    np.testing.assert_allclose(poses.numpy(), poses_est, atol=2e-2)
    np.testing.assert_allclose(got.delta_sum.numpy(), frames.delta_sum,
                               rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(np.log(got.cond.numpy()),
                               np.log(frames.cond), rtol=0.05)
    assert got.poses.shape == (N, 0)
    assert got.trace_cond.shape == (N, JCFG.max_gn_iters)
    mask = tslam.observed_times_mask(_obs(traj))
    want_mask = jslam.observed_times_mask(_jobs(traj))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_simulate_with_noise_reproduces_jax(course):
    """The normals JAX's ``simulate`` draws (its key splits,
    ``frontend.py:112, 126, 132``) fed to the port give its trajectory."""
    traj = course[0]
    num_l = len(jslam.REF_SLAM_LANDMARKS)
    k0, kscan = jax.random.split(jax.random.key(3))
    scan_noise = [jax.random.normal(kscan, (num_l, 3))]
    motion_noise = []
    for k in jax.random.split(k0, N):
        k_mv, k_sc = jax.random.split(k)
        motion_noise.append(jax.random.normal(k_mv, (3,)))
        scan_noise.append(jax.random.normal(k_sc, (num_l, 3)))
    got = tslam.simulate_with_noise(
        tslam.SlamSceneConfig(), TCFG,
        torch.from_numpy(np.stack(motion_noise)),
        torch.from_numpy(np.stack(scan_noise)))
    for name in ("poses_actu", "poses_odom"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(traj, name), atol=1e-5)
    for g_obs, w_obs in ((got.obs, traj.obs), (got.obs_true, traj.obs_true)):
        for g, w in zip(g_obs[:3], w_obs[:3]):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g_obs.valid.numpy(), w_obs.valid)


def _seed(traj, s):
    return tslam.SlamTrajectory(
        traj.poses_actu[s], traj.poses_odom[s],
        tslam.GraphObservations(*(t[s] for t in traj.obs)),
        tslam.GraphObservations(*(t[s] for t in traj.obs_true)))


def test_batched_equals_per_seed():
    gen = torch.Generator().manual_seed(11)
    traj, poses, frames = tslam.slam_rollout(
        tslam.SlamSceneConfig(), TCFG, gen, N, device="cpu", seeds=3)
    assert poses.shape == (3, T1, 3) and frames.gn_iters.shape == (3, N)
    assert frames.trace_det.shape == (3, N, JCFG.max_gn_iters)
    for s in range(3):
        p1, f1 = tslam.estimate_frames(TCFG, _seed(traj, s))
        np.testing.assert_allclose(poses[s].numpy(), p1.numpy(), atol=1e-5)
        assert torch.equal(frames.is_calc[s], f1.is_calc)
        assert torch.equal(frames.gn_iters[s], f1.gn_iters)
        np.testing.assert_allclose(frames.delta_sum[s].numpy(),
                                   f1.delta_sum.numpy(), rtol=1e-4,
                                   atol=1e-6)
        for name in ("det", "cond", "trace_det", "trace_cond"):
            np.testing.assert_allclose(getattr(frames, name)[s].numpy(),
                                       getattr(f1, name).numpy(), rtol=1e-4)
        np.testing.assert_allclose(frames.trace_delta_sum[s].numpy(),
                                   f1.trace_delta_sum.numpy(), rtol=1e-4,
                                   atol=1e-6)
    # One solve of the batch with a time per seed: each seed as alone.
    t_now = torch.tensor([2, N, 4])
    res = tslam.graph_solve(TCFG, traj.poses_odom, traj.obs, t_now=t_now)
    for s in range(3):
        one = tslam.graph_solve(TCFG, traj.poses_odom[s],
                                _seed(traj, s).obs, t_now=int(t_now[s]))
        assert int(res.gn_iters[s]) == int(one.gn_iters)
        assert bool(res.is_calc[s]) == bool(one.is_calc)
        np.testing.assert_allclose(res.poses[s].numpy(), one.poses.numpy(),
                                   atol=1e-5)


def test_no_pairs_no_update():
    """Every landmark seen at most once: nothing is calculable (reference:
    leng <= 3 -> is_calc False, :469); float32 and float64."""
    cfg = tslam.reference_course_config(3)
    for dtype in (torch.float32, torch.float64):
        valid = torch.zeros((4, 9), dtype=torch.bool)
        valid[0, 0] = True
        obs = tslam.GraphObservations(torch.ones((4, 9), dtype=dtype),
                                      torch.zeros((4, 9), dtype=dtype),
                                      torch.zeros((4, 9), dtype=dtype), valid)
        res = tslam.graph_solve(cfg, torch.zeros((4, 3), dtype=dtype), obs,
                                t_now=3)
        assert not bool(res.is_calc)
        assert int(res.gn_iters) == 1
        assert torch.equal(res.poses, torch.zeros((4, 3), dtype=dtype))


@pytest.mark.parametrize("over", [dict(guard="off"),
                                  dict(guard="cheap", damping=0.05)],
                         ids=["guard_off", "damped"])
def test_solve_options_match_jax(course, over):
    traj = course[0]
    jcfg = jslam.reference_course_config(N, **over)
    got = tslam.graph_solve(graph_config_from(jcfg),
                            torch.from_numpy(traj.poses_odom), _obs(traj))
    want = jslam.graph_solve(jcfg, jnp.asarray(traj.poses_odom), _jobs(traj))
    assert bool(got.is_calc) == bool(want.is_calc)
    assert int(got.gn_iters) == int(want.gn_iters)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=2e-2)


def test_solve_once_deterministic_and_converges():
    cfg = tslam.reference_course_config(9)
    scene = tslam.SlamSceneConfig()
    t1, r1 = tslam.solve_once(scene, cfg, torch.Generator().manual_seed(5),
                              9, device="cpu")
    t2, r2 = tslam.solve_once(scene, cfg, torch.Generator().manual_seed(5),
                              9, device="cpu")
    assert torch.equal(r1.poses, r2.poses)
    assert bool(r1.is_calc)
    assert float(r1.delta_sum) < cfg.delta_sum_threshold
    assert r1.poses.shape == (10, 3) and t1.obs.valid.dtype == torch.bool
    with pytest.raises(ValueError, match="controls"):
        tslam.simulate(scene, cfg, torch.Generator(), 9,
                       controls=np.zeros((8, 2)), device="cpu")


def test_graph_fast_band():
    """The 6-frame course over 64 seeds against the reference's
    ``graph_fast`` band (the statistics and check of
    ``tests/test_distributional.py::_graph_course_stats``, with
    ``max_frame_iters``)."""
    bands = json.loads(FIXTURE.read_text())
    section = "graph_fast"
    n_frames, n_ref = bands[section + "_frames"], bands[section]["n_seeds"]
    cfg = tslam.reference_course_config(n_frames)
    gen = torch.Generator().manual_seed(5150)
    stats = []
    for _ in range(4):
        traj, poses, frames = tslam.slam_rollout(
            tslam.SlamSceneConfig(), cfg, gen, n_frames, device="cpu",
            seeds=16)
        mask = tslam.observed_times_mask(traj.obs)
        e2 = ((poses[..., :2] - traj.poses_actu[..., :2]) ** 2).sum(-1)
        rmse = torch.sqrt(torch.where(mask, e2, 0.0).sum(-1) / mask.sum(-1))
        iters = frames.gn_iters.clamp(max=cfg.max_gn_iters)
        stats.append(torch.stack([
            rmse.double(), iters.sum(-1).double(),
            iters.amax(-1).double(), (~frames.is_calc).sum(-1).double()],
            dim=-1))
    rmse, total, max_iters, fails = torch.cat(stats).numpy().T
    ref = bands[section]
    check(section + ".rmse_pos", rmse, ref["rmse_pos"], n_ref)
    check(section + ".total_gn_iters", total, ref["total_gn_iters"], n_ref)
    check(section + ".max_frame_iters", max_iters, ref["max_frame_iters"],
          n_ref)
    tol = K_SIGMA * np.sqrt(ref["calc_failures"]["std"] ** 2 / n_ref
                            + fails.std(ddof=1) ** 2 / fails.size)
    assert abs(fails.mean() - ref["calc_failures"]["mean"]) <= max(tol, 1.0)


def test_slam_keeps_jax_out():
    code = (
        "import sys\n"
        "import tpuslam_torch.slam, tpuslam_torch.convert\n"
        "import tpuslam_torch.core.chi2, tpuslam_torch.core.ellipse\n"
        "import tpuslam_torch.models.motion\n"
        "import tpuslam_torch.models.scan_sensor\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpuslam')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=pathlib.Path(tpuslam_torch.__file__).parent
                          .parent)
    assert proc.returncode == 0, proc.stderr
