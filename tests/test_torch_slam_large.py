"""Large-scale graph SLAM in the port (``tpuslam_torch/slam/large.py``):
windowed edges, the flat banded assembly, the odometry chain, the
banded matvecs and CG, the synthetic scene and the GN loop, against the
JAX package.

Inputs are the JAX package's own 100-pose scene (key 3) carried across
as numpy, or are made from a numpy seed.  Tolerances: the float64 port
against the float64 JAX package at 1e-10 of the largest magnitude, with
equal ``gn_iters`` and CG iterations; edge lists exactly; the scene from
JAX's own draws to 1e-5; float32 port paths against each other or a
dense solve at ``tests/test_large_graph.py``'s bounds.  The assembly's
gather tables must give bit-equal repeats.  Each test runs on one torch
thread.
"""

import contextlib
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.slam.large as jlarge
from tpuslam.core.angles import wrap_angle as jwrap
from tpuslam.models.scan_sensor import ScanConfig
from tpuslam.slam import GraphConfig
from tpuslam_torch.convert import (banded_result_to_numpy,
                                   edge_list_from_numpy, graph_config_from,
                                   graph_observations_from_numpy)
from tpuslam_torch.core.angles import wrap_angle as twrap
import tpuslam_torch.slam as tslam
import tpuslam_torch.slam.large as tlarge

F64 = 1e-10
NOISE = 0.3
CG_CAP = 40
T1, LMS, WINDOW = 100, 20, 20


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


def _close(got, want, rtol=F64):
    """Arrays equal to ``rtol`` of the largest magnitude."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _cfg(t1, num_lm, **kw):
    return GraphConfig(
        max_times=t1, num_landmarks=num_lm,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)), **kw)


def _rel_odom(po):
    rel = po[1:] - po[:-1]
    return torch.cat([rel[:, :2], twrap(rel[:, 2:3])], dim=1)


def _edge_set(el):
    return {(int(b), int(a), int(m)) for b, a, m, ok in
            zip(el.t_b.tolist(), el.t_a.tolist(), el.lm.tolist(),
                el.valid.tolist()) if ok}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_scene(seed, t1, lms, radius, noise, **kw):
    cfg = graph_config_from(_cfg(t1, lms, exact_jacobians=True, **kw))
    gen = torch.Generator().manual_seed(seed)
    pt, po, obs = tslam.make_large_scene(cfg, gen, t1, lms, radius=radius,
                                         odom_noise=noise, device="cpu")
    return cfg, pt, po, obs


def _rmse(poses, pt):
    return float(((poses[:, :2] - pt[:, :2]) ** 2).sum(-1).mean().sqrt())


@pytest.fixture(scope="module")
def scene():
    """The JAX package's 100-pose scene (key 3) as numpy, its edge list,
    JAX's draws for it, and float64 JAX results on it: both assemblies,
    the exact terms and rhs, a flat CG solve, and a CG GN solve."""
    jcfg = _cfg(T1, LMS, max_gn_iters=10, exact_jacobians=True)
    key = jax.random.key(3)
    pt, po, obs = jax.jit(lambda k: jlarge.make_large_scene(
        jcfg, k, T1, LMS, radius=40.0, odom_noise=NOISE))(key)
    out = {"jcfg": jcfg, "pt": np.asarray(pt), "po": np.asarray(po),
           "obs": jax.tree_util.tree_map(np.asarray, obs)}
    out["el"] = jax.tree_util.tree_map(
        np.asarray, jlarge.window_pairs(out["obs"].valid, window=WINDOW))

    def refs(po, obs, el):
        poses = po + 0.01 * jnp.sin(jnp.arange(T1))[:, None]
        res = {}
        for exact in (True, False):
            c = _cfg(T1, LMS, max_gn_iters=10, exact_jacobians=exact)
            blocks = jlarge.build_edge_blocks(c, poses, obs, el,
                                              omega_poses=po)
            res[exact] = jlarge.assemble_banded_flat(c, blocks, el, T1,
                                                     WINDOW)
        om, rel_obs, mask = jlarge.exact_edge_terms(jcfg, obs, el, po)
        rel = po[1:] - po[:-1]
        rel = rel.at[:, 2].set(jwrap(rel[:, 2]))
        h, b = jlarge.add_odometry_chain_flat(
            res[True][0], res[True][1], poses, rel, (1 / NOISE ** 2,) * 3)
        return {"asm": res, "om": om, "rel_obs": rel_obs, "mask": mask,
                "rhs": jlarge.exact_rhs_flat(poses, om, rel_obs, el, T1),
                "chain": (h, b),
                "cg": jlarge.cg_solve_flat(h, -b, WINDOW, CG_CAP, 0.0),
                "gn": jlarge.graph_solve_banded(
                    jcfg, po, obs, el, band=WINDOW, rel_odom=rel,
                    odom_info=(1 / NOISE ** 2,) * 3, solver="cg",
                    cg_iters=CG_CAP)}

    with _x64():
        obs64 = type(out["obs"])(*(a.astype(np.float64)
                                   for a in out["obs"][:3]),
                                 out["obs"].valid)
        out["want64"] = jax.tree_util.tree_map(
            np.asarray, jax.jit(refs)(out["po"].astype(np.float64), obs64,
                                      out["el"]))
    return out


def jax_scene_draws(seed: int, n: int, lms: int, scan_chunk=None) -> dict:
    """The draws of the JAX package's ``make_large_scene`` for
    ``jax.random.key(seed)`` (its key splits, ``large.py:688-725``), as
    numpy: what ``make_large_scene_with_noise`` takes."""
    def draws(key):
        k_lm, k_scan, k_odo = jax.random.split(key, 3)
        if scan_chunk is None:
            scan = jax.random.normal(k_scan, (n, lms, 3))
        else:
            scan = jnp.concatenate([
                jax.random.normal(k, (scan_chunk, lms, 3))
                for k in jax.random.split(k_scan, n // scan_chunk)])
        return {
            "lm_offsets": jax.random.uniform(k_lm, (lms,), minval=-10.0,
                                             maxval=10.0),
            "lm_perm": jax.random.permutation(
                k_lm, jnp.arange(lms, dtype=jnp.float32)),
            "scan_normals": scan,
            "odom_normals": jax.random.normal(k_odo, (n, 3)),
        }

    out = {k: np.asarray(v) for k, v in
           jax.jit(draws)(jax.random.key(seed)).items()}
    out["lm_perm"] = out["lm_perm"].astype(np.int64)
    return out


DRAW_NAMES = ("lm_offsets", "lm_perm", "scan_normals", "odom_normals")
#: TestLargeSceneEndToEnd's scene (key 0, 200 poses, 40 landmarks): the
#: JAX package's draws, which ``chip_smoke.py`` rebuilds the scene from
#: on the card.  Written by ``PYTHONPATH=. python
#: tests/test_torch_slam_large.py``.
E2E_FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
               / "large_scene_key0.npz")
E2E = dict(seed=0, n=200, lms=40)


def _port(scene, dtype=torch.float64):
    obs = graph_observations_from_numpy(scene["obs"], device="cpu")
    obs = tslam.GraphObservations(*(t.to(dtype) for t in obs[:3]),
                                  obs.valid)
    po = _t(scene["po"]).to(dtype)
    return (graph_config_from(scene["jcfg"]), po, obs,
            edge_list_from_numpy(scene["el"], device="cpu"))


# --- Edges ---------------------------------------------------------------

class TestWindowPairs:
    def test_full_window_is_all_pairs(self):
        valid = np.zeros((5, 2), bool)
        valid[[0, 2, 4], 0] = True
        valid[[1, 3], 1] = True
        el = tslam.window_pairs(valid, window=10, device="cpu")
        # landmark 0: (0,2),(0,4),(2,4); landmark 1: (1,3) -> 4 edges
        assert el.t_b.shape == (4,)
        assert el.valid.all()

    def test_window_limits_span(self):
        valid = np.zeros((10, 1), bool)
        valid[[0, 3, 9], 0] = True
        el = tslam.window_pairs(torch.from_numpy(valid), window=4)
        assert set(zip(el.t_b.tolist(), el.t_a.tolist())) == {(0, 3)}

    @pytest.mark.parametrize("window,cap", [(1, None), (3, None), (40, None),
                                            (40, 2)])
    def test_matches_jax_in_order(self, rng, window, cap):
        valid = rng.random((40, 6)) < 0.4
        want = jlarge.window_pairs(valid, window=window, max_pairs_per_lm=cap)
        got = tslam.window_pairs(valid, window=window, max_pairs_per_lm=cap,
                                 device="cpu")
        for name in ("t_b", "t_a", "lm", "valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        if cap is None:
            assert len(got.t_b) == tslam.count_window_pairs(valid, window) \
                == jlarge.count_window_pairs(valid, window)

    def test_numpy_needs_a_device(self):
        with pytest.raises(ValueError, match="device"):
            tslam.window_pairs(np.ones((4, 2), bool), window=2)


class TestWindowPairsDevice:
    @pytest.mark.parametrize("window", [1, 3, 40])
    def test_matches_host_and_jax(self, rng, window):
        """The same edge set as the host build, and JAX's device build
        slot for slot; the true count returned."""
        valid = rng.random((40, 6)) < 0.4
        n_exact = tslam.count_window_pairs(valid, window)
        host = tslam.window_pairs(valid, window=window, device="cpu")
        dev, n = tslam.window_pairs_device(torch.from_numpy(valid), window,
                                           n_exact + 5)
        assert int(n) == n_exact and host.t_b.shape[0] == n_exact
        assert _edge_set(dev) == _edge_set(host)
        if window != 3:  # one JAX compile: its lag loop is unrolled
            return
        jdev, jn = jax.jit(lambda v: jlarge.window_pairs_device(
            v, window, n_exact + 5))(jnp.asarray(valid))
        assert int(jn) == n_exact
        for name in ("t_b", "t_a", "lm", "valid"):
            np.testing.assert_array_equal(getattr(dev, name).numpy(),
                                          np.asarray(getattr(jdev, name)))

    def test_truncation_reports_count(self, rng):
        valid = torch.from_numpy(rng.random((20, 3)) < 0.8)
        el, n = tslam.window_pairs_device(valid, window=10, max_edges=4)
        assert int(n) > 4  # true count reported
        assert int(el.valid.sum()) == 4  # list truncated to capacity

    def test_solve_with_device_edges(self):
        cfg, pt, po, obs = _port_scene(1, 60, 12, 15.0, 0.05,
                                       max_gn_iters=5)
        w = 10
        n = tslam.count_window_pairs(obs.valid, w)
        el_host = tslam.window_pairs(obs.valid, window=w)
        el_dev, _ = tslam.window_pairs_device(obs.valid, w, n)
        kw = dict(band=w, rel_odom=_rel_odom(po), solver="tridiag")
        res_h = tslam.graph_solve_banded(cfg, po, obs, el_host, **kw)
        res_d = tslam.graph_solve_banded(cfg, po, obs, el_dev, **kw)
        np.testing.assert_allclose(res_d.poses.numpy(), res_h.poses.numpy(),
                                   atol=1e-4)


# --- Edge terms and assembly ---------------------------------------------

class TestBandedVsDense:
    @staticmethod
    def _course(t_steps=8, seed=0):
        """The port's own 8-step course (the dense path's simulator)."""
        cfg = graph_config_from(_cfg(t_steps + 1, 9))
        traj = tslam.simulate(tslam.SlamSceneConfig(), cfg,
                              torch.Generator().manual_seed(seed), t_steps,
                              device="cpu")
        obs = tslam.GraphObservations(*(t.double() for t in traj.obs[:3]),
                                      traj.obs.valid)
        return cfg, traj.poses_odom.double(), obs

    @staticmethod
    def _dense_from_band(h_band):
        hb = h_band.double().numpy()
        t1 = hb.shape[1]
        h = np.zeros((3 * t1, 3 * t1))
        for d in range(hb.shape[0]):
            for i in range(t1 - d):
                h[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3] += hb[d, i]
                if d:
                    h[3 * (i + d):3 * (i + d) + 3,
                      3 * i:3 * i + 3] += hb[d, i].T
        return h

    def test_banded_assembly_matches_dense(self):
        """Full-window banded H and b equal the dense path's (float64,
        the reference's Jacobians on both)."""
        cfg, po, obs = self._course()
        t1 = 9
        el = tslam.window_pairs(obs.valid, window=t1)
        blocks = tslam.build_edge_blocks(cfg, po, obs, el)
        h_band, bvec, kept = tslam.assemble_banded(cfg, blocks, el, t1,
                                                   band=t1 - 1)
        pi, pj = tslam.upper_pairs(t1)
        edges = tslam.build_edges(cfg, po, obs, t1 - 1, pi, pj)
        kept_d = tslam.kept_times(obs, t1 - 1)
        h_dense, b_dense = tslam.assemble(cfg, edges, kept_d, pi, pj, t1)
        np.testing.assert_array_equal(kept.numpy(), kept_d.numpy())
        _close(self._dense_from_band(h_band), h_dense.numpy())
        _close(bvec.numpy().ravel(), b_dense.numpy())

    def test_matvec_matches_dense(self, rng):
        cfg, po, obs = self._course()
        t1 = 9
        el = tslam.window_pairs(obs.valid, window=t1)
        h_band, _, _ = tslam.assemble_banded(
            cfg, tslam.build_edge_blocks(cfg, po, obs, el), el, t1,
            band=t1 - 1)
        x = rng.normal(size=(t1, 3))
        y = tslam.banded_matvec(h_band, _t(x)).numpy()
        want = (self._dense_from_band(h_band) @ x.reshape(-1)).reshape(t1, 3)
        _close(y, want)

    def test_cg_matches_direct_solve(self):
        cfg, po, obs = self._course()
        t1 = 9
        el = tslam.window_pairs(obs.valid, window=t1)
        h_band, bvec, _ = tslam.assemble_banded(
            cfg, tslam.build_edge_blocks(cfg, po, obs, el), el, t1,
            band=t1 - 1)
        x, iters = tslam.cg_solve(h_band, bvec, max_iters=500, tol=1e-24)
        hx = tslam.banded_matvec(h_band, x)
        res = float((hx - bvec).norm() / (bvec.norm() + 1e-30))
        assert res < 1e-9
        assert int(iters) < 500
        _close(x.numpy().ravel(),
               np.linalg.solve(self._dense_from_band(h_band),
                               bvec.numpy().ravel()), rtol=1e-8)


class TestAssemblyAgainstJax:
    @pytest.mark.parametrize("exact", [True, False])
    def test_assembly_matches_jax(self, scene, exact):
        cfg, po, obs, el = _port(scene)
        cfg = graph_config_from(_cfg(T1, LMS, exact_jacobians=exact))
        poses = po + 0.01 * torch.sin(torch.arange(T1,
                                                   dtype=po.dtype))[:, None]
        blocks = tslam.build_edge_blocks(cfg, poses, obs, el, omega_poses=po)
        got = tlarge.assemble_banded_flat(cfg, blocks, el, T1, WINDOW)
        want = scene["want64"]["asm"][exact]
        _close(got[0], want[0])
        _close(got[1], want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])

    def test_exact_terms_and_rhs_match_jax(self, scene):
        """``exact_edge_terms``/``exact_rhs_flat`` equal JAX's, and the
        rhs equals the full assembly's b bit for bit."""
        cfg, po, obs, el = _port(scene)
        want = scene["want64"]
        poses = po + 0.01 * torch.sin(torch.arange(T1,
                                                   dtype=po.dtype))[:, None]
        om, rel_obs, mask = tlarge.exact_edge_terms(cfg, obs, el, po)
        _close(om, want["om"])
        _close(rel_obs, want["rel_obs"])
        np.testing.assert_array_equal(mask.numpy(), want["mask"])
        _close(tlarge.exact_edge_omega(cfg, obs, el, po, mask), want["om"])
        rhs = tlarge.exact_rhs_flat(poses, om, rel_obs, el, T1)
        _close(rhs, want["rhs"])
        blocks = tslam.build_edge_blocks(cfg, poses, obs, el, omega_poses=po)
        _, b_full, _ = tlarge.assemble_banded_flat(cfg, blocks, el, T1,
                                                   WINDOW)
        np.testing.assert_array_equal(rhs.numpy(), b_full.numpy())

    def test_odometry_chain_matches_jax_and_band_form(self, scene):
        cfg, po, obs, el = _port(scene)
        poses = po + 0.01 * torch.sin(torch.arange(T1,
                                                   dtype=po.dtype))[:, None]
        h, b, _ = tlarge.assemble_banded_flat(
            cfg, tslam.build_edge_blocks(cfg, poses, obs, el,
                                         omega_poses=po), el, T1, WINDOW)
        info = (1 / NOISE ** 2,) * 3
        hc, bc = tlarge.add_odometry_chain_flat(h, b, poses, _rel_odom(po),
                                                info)
        _close(hc, scene["want64"]["chain"][0])
        _close(bc, scene["want64"]["chain"][1])
        h_band = h.reshape(WINDOW + 1, 9, T1).transpose(1, 2).reshape(
            WINDOW + 1, T1, 3, 3)
        hb2, bv2 = tslam.add_odometry_chain(h_band, b.T, poses, _rel_odom(po),
                                            info)
        np.testing.assert_array_equal(
            hb2.reshape(WINDOW + 1, T1, 9).transpose(1, 2).reshape(-1, T1)
            .numpy(), hc.numpy())
        np.testing.assert_array_equal(bv2.T.numpy(), bc.numpy())

    def test_gather_tables_repeat_bit_for_bit(self, scene):
        """The grouped assembly is a fixed-order sum: repeats give the
        same bits, each edge term sits in exactly one table slot, and the
        sums equal a scatter-add's to float64 rounding."""
        cfg, po, obs, el = _port(scene, torch.float32)
        blocks = tslam.build_edge_blocks(cfg, po, obs, el)
        first = tlarge.assemble_banded_flat(cfg, blocks, el, T1, WINDOW)
        scatter = tlarge.build_banded_scatter(el, T1, WINDOW)
        again = tlarge.assemble_banded_flat(cfg, blocks, el, T1, WINDOW,
                                            scatter=scatter)
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        e = el.t_b.shape[0]
        for table, n in ((scatter.blk_table, 3 * e),
                         (scatter.col_table, 2 * e)):
            slots = table[table < n]
            assert torch.equal(slots.sort().values, torch.arange(n))
        # against index_add_ in float64 (the JAX package's scatter-adds)
        b64 = {k: v.double() if v.is_floating_point() else v
               for k, v in blocks.items()}
        h64 = torch.zeros((WINDOW + 1) * 9, T1, dtype=torch.float64)
        d = el.t_a - el.t_b
        for k in range(9):
            r, c = divmod(k, 3)
            h64[k].index_add_(0, el.t_b, b64["h_bb"][:, r, c])
            h64[k].index_add_(0, el.t_a, b64["h_aa"][:, r, c])
            h64.view(-1).index_add_(0, (d * 9 + k) * T1 + el.t_b,
                                    b64["h_ba"][:, r, c])
        got64, _, kept = tlarge.assemble_banded_flat(
            cfg, b64, el, T1, WINDOW, scatter=scatter)
        fix = got64.clone()
        for k in (0, 4, 8):
            fix[k] -= torch.where(kept, 0.0, 1.0).double()
            fix[k, int(kept.int().argmax())] -= cfg.anchor
        _close(fix, h64.numpy(), rtol=1e-13)


# --- Matvec and CG -------------------------------------------------------

def _random_flat(rng, t1, band):
    d1 = band + 1
    h_flat = np.zeros((d1 * 9, t1))
    for d in range(d1):
        blk = rng.normal(size=(t1, 3, 3)) * 0.3
        if d == 0:
            blk = 0.5 * (blk + blk.transpose(0, 2, 1))
            blk += np.eye(3)[None] * (band + 4.0)
        h_flat[d * 9:(d + 1) * 9] = blk.reshape(t1, 9).T
        if d:
            h_flat[d * 9:(d + 1) * 9, t1 - d:] = 0.0
    return h_flat, rng.normal(size=(3, t1))


def _band_of(h_flat, band):
    t1 = h_flat.shape[1]
    return h_flat.reshape(band + 1, 9, t1).transpose(1, 2).reshape(
        band + 1, t1, 3, 3)


class TestFlatCg:
    @pytest.mark.parametrize("t1,band", [(48, 4), (60, 3), (23, 4)])
    def test_matvec_matches_band_and_jax(self, rng, t1, band):
        h_flat, b3 = _random_flat(rng, t1, band)
        h_flat, b3 = _t(h_flat), _t(b3)
        y_band = tlarge.make_banded_matvec(_band_of(h_flat, band))(b3.T)
        y_flat = tlarge.make_banded_matvec_flat(h_flat, band)(b3)
        _close(y_flat.T, y_band.numpy())
        with _x64():
            want = jax.jit(lambda h, x: jlarge.make_banded_matvec_flat(
                h, band)(x))(jnp.asarray(h_flat.numpy()),
                             jnp.asarray(b3.numpy()))
        _close(y_flat, np.asarray(want))

    @pytest.mark.parametrize("t1,band", [(48, 4), (60, 3)])
    def test_cg_matches_band_cg(self, rng, t1, band):
        h_flat, b3 = _random_flat(rng, t1, band)
        h32, b32 = _t(h_flat).float(), _t(b3).float()
        x_band, _ = tlarge.cg_solve(_band_of(h32, band), b32.T, max_iters=500,
                                    tol=1e-12)
        x_flat, _ = tlarge.cg_solve_flat(h32, b32, band, max_iters=500,
                                         tol=1e-12)
        np.testing.assert_allclose(x_flat.numpy(), x_band.numpy(),
                                   rtol=2e-4, atol=2e-5)

    def test_cg_flat_matches_jax(self, scene):
        """On the scene's assembled system with the odometry chain: the
        same iterates as JAX for CG_CAP iterations, and the converged
        solve against a dense one.  (Past ~100 iterations CG on this
        system, whose anchor makes it stiff, amplifies the last bit of a
        matvec's summation order: the packages then part at 1e-4 after
        200 iterations, and converge at 265 and 292.)"""
        want = scene["want64"]
        h, b = (_t(a) for a in want["chain"])
        x, iters = tlarge.cg_solve_flat(h, -b, WINDOW, CG_CAP, 0.0)
        assert int(iters) == int(want["cg"][1]) == CG_CAP
        _close(x, want["cg"][0])
        x, iters = tlarge.cg_solve_flat(h, -b, WINDOW, 3 * T1 * 3, 1e-24)
        dense = np.zeros((3 * T1, 3 * T1))
        hb = _band_of(h, WINDOW).numpy()
        for d in range(WINDOW + 1):
            for i in range(T1 - d):
                dense[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3] += hb[d, i]
                if d:
                    dense[3 * (i + d):3 * (i + d) + 3,
                          3 * i:3 * i + 3] += hb[d, i].T
        _close(x.numpy().ravel(),
               np.linalg.solve(dense, -b.T.numpy().ravel()), rtol=1e-8)

    def test_graph_solve_cg_matches_jax(self, scene):
        """The CG GN loop, each inner solve capped at CG_CAP iterations
        (see ``test_cg_flat_matches_jax``)."""
        cfg, po, obs, el = _port(scene)
        res = banded_result_to_numpy(tslam.graph_solve_banded(
            cfg, po, obs, el, band=WINDOW, rel_odom=_rel_odom(po),
            odom_info=(1 / NOISE ** 2,) * 3, solver="cg", cg_iters=CG_CAP))
        want = scene["want64"]["gn"]
        assert int(res.gn_iters) == int(want.gn_iters)
        assert int(res.cg_iters_last) == int(want.cg_iters_last)
        _close(res.poses, want.poses)

    def test_graph_solve_cg_and_tridiag_agree(self):
        cfg, pt, po, obs = _port_scene(0, 200, 30, 60.0, 0.05,
                                       max_gn_iters=6)
        el = tslam.window_pairs(obs.valid, window=12)
        kw = dict(band=12, rel_odom=_rel_odom(po),
                  odom_info=(100.0, 100.0, 100.0), delta_tol=1e-4 * 200)
        r_td = tslam.graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                        **kw)
        r_cg = tslam.graph_solve_banded(cfg, po, obs, el, solver="cg", **kw)
        assert np.isfinite(r_td.poses.numpy()).all()
        assert int(r_td.gn_iters) >= 1
        np.testing.assert_allclose(r_cg.poses.numpy(), r_td.poses.numpy(),
                                   atol=2e-2)


# --- The scene -----------------------------------------------------------

class TestChunkedScene:
    def test_chunked_scan_matches_visibility(self):
        cfg = graph_config_from(_cfg(40, 8, exact_jacobians=True))

        def make(chunk):
            return tslam.make_large_scene(
                cfg, torch.Generator().manual_seed(1), 40, 8, radius=15.0,
                odom_noise=0.05, scan_chunk=chunk, device="cpu")

        pt, po, obs = make(None)
        pt2, po2, obs2 = make(10)
        np.testing.assert_array_equal(obs.valid.numpy(), obs2.valid.numpy())
        np.testing.assert_array_equal(pt.numpy(), pt2.numpy())
        # the odometry is drawn before the scan, whatever the chunking
        np.testing.assert_array_equal(po.numpy(), po2.numpy())
        assert obs2.dist.shape == obs.dist.shape
        assert np.isfinite(obs2.dist.numpy()).all()

    def test_chunk_must_divide(self):
        cfg = graph_config_from(_cfg(40, 8))
        with pytest.raises(ValueError, match="must divide"):
            tslam.make_large_scene(cfg, torch.Generator(), 40, 8,
                                   scan_chunk=7, device="cpu")

    def test_generator_must_be_on_the_device(self):
        cfg = graph_config_from(_cfg(40, 8))
        with pytest.raises(ValueError, match="generator"):
            tslam.make_large_scene(cfg, torch.Generator(), 40, 8,
                                   device="meta")

    @pytest.mark.parametrize("chunk", [None, 10])
    def test_with_noise_reproduces_jax(self, scene, chunk):
        """Fed JAX's own draws, the scene is JAX's (to 1e-5; the
        visibility exactly)."""
        jcfg = scene["jcfg"]
        draws = jax_scene_draws(3, T1, LMS, chunk)
        if chunk is None:
            want = (scene["pt"], scene["po"], scene["obs"])
        else:
            want = jax.tree_util.tree_map(np.asarray, jax.jit(
                lambda k: jlarge.make_large_scene(
                    jcfg, k, T1, LMS, radius=40.0, odom_noise=NOISE,
                    scan_chunk=chunk))(jax.random.key(3)))
        got = tslam.make_large_scene_with_noise(
            graph_config_from(jcfg), T1, LMS,
            *(_t(draws[k]) for k in DRAW_NAMES), radius=40.0,
            odom_noise=NOISE, scan_chunk=chunk)
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5)
        np.testing.assert_array_equal(got[2].valid.numpy(), want[2].valid)
        for g, w in zip(got[2][:3], want[2][:3]):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


# --- Gauss-Newton end to end ---------------------------------------------

class TestLargeSceneEndToEnd:
    def test_fixture_holds_jax_draws(self):
        """The committed draws are JAX's own for the end-to-end scene."""
        with np.load(E2E_FIXTURE) as f:
            got = {k: f[k] for k in DRAW_NAMES}
        want = jax_scene_draws(**E2E)
        for k in DRAW_NAMES:
            np.testing.assert_array_equal(got[k], want[k])

    def test_solve_converges_and_improves(self):
        """JAX's 200-pose / 40-landmark scene (key 0, rebuilt from its
        draws) with heavy odometry drift: GN with the odometry chain and
        exact Jacobians cuts the drift against truth below 0.7 of the
        odometry's (the CG default solver)."""
        noise = 0.3
        cfg = graph_config_from(_cfg(200, 40, max_gn_iters=20,
                                     exact_jacobians=True))
        with np.load(E2E_FIXTURE) as f:
            pt, po, obs = tslam.make_large_scene_with_noise(
                cfg, 200, 40, *(_t(f[k]) for k in DRAW_NAMES), radius=60.0,
                odom_noise=noise)
        el = tslam.window_pairs(obs.valid, window=30)
        assert el.t_b.shape[0] > 100
        res = tslam.graph_solve_banded(cfg, po, obs, el, band=30,
                                       rel_odom=_rel_odom(po),
                                       odom_info=(1 / noise ** 2,) * 3)
        assert math.isfinite(_rmse(res.poses, pt))
        assert _rmse(res.poses, pt) < 0.7 * _rmse(po, pt)
        assert int(res.gn_iters) >= 1

    def test_no_nan_without_odometry_chain(self):
        cfg, pt, po, obs = _port_scene(1, 100, 20, 40.0, 0.1,
                                       max_gn_iters=10)
        el = tslam.window_pairs(obs.valid, window=20)
        res = tslam.graph_solve_banded(cfg, po, obs, el, band=20)
        assert np.isfinite(res.poses.numpy()).all()

    def test_solver_names(self, scene):
        """Every solver of the JAX package runs, and so does ``n_parts``,
        on the scene with its odometry chain (without it the direct
        solvers give NaN poses in both packages); an unknown name
        raises."""
        cfg, po, obs, el = _port(scene, torch.float32)
        runs = [dict(solver="cr"), dict(solver="cholesky"),
                dict(solver="tridiag", n_parts=4)]
        for kw in runs:
            res = tslam.graph_solve_banded(
                cfg, po, obs, el, band=WINDOW, rel_odom=_rel_odom(po),
                odom_info=(1 / NOISE ** 2,) * 3, **kw)
            assert np.isfinite(res.poses.numpy()).all(), kw
            assert int(res.gn_iters) >= 1, kw
        with pytest.raises(ValueError, match="unknown solver"):
            tslam.graph_solve_banded(cfg, po, obs, el, band=WINDOW,
                                     solver="thomas")


class TestDamping:
    def test_damped_reference_formulation_stays_bounded(self):
        """The reference-compatible formulation (its Jacobians,
        relinearized Omega) with Levenberg damping stays finite and
        bounded at 200 poses."""
        cfg = graph_config_from(_cfg(200, 40, max_gn_iters=15))
        pt, po, obs = tslam.make_large_scene(
            cfg, torch.Generator().manual_seed(0), 200, 40, radius=60.0,
            odom_noise=0.1, device="cpu")
        el = tslam.window_pairs(obs.valid, window=30)
        res = tslam.graph_solve_banded(
            cfg, po, obs, el, band=30, rel_odom=_rel_odom(po),
            odom_info=(100.0,) * 3, relinearize_omega=True, damping=1.0)
        assert np.isfinite(res.poses.numpy()).all()
        assert _rmse(res.poses, pt) < 10.0

    def test_negative_damping_is_refused(self, scene):
        cfg, po, obs, el = _port(scene, torch.float32)
        with pytest.raises(ValueError, match="damping must be >= 0"):
            tslam.graph_solve_banded(cfg, po, obs, el, band=WINDOW,
                                     damping=-0.1)


class TestBenchConfig:
    def test_bench_config_matches_jax(self):
        """``bench_graph_large``'s config (bench.py:206-231: odometry
        noise 0.1, radius 0.3 x poses, odom_info 100, tridiag, stall_ratio
        0.5, delta_tol 1e-6 x poses) at 200 poses / 20 landmarks, window
        30, on the JAX package's scene (key 0): the same GN iterations and
        poses as JAX in float32.  Its stall check stops GN after 4
        iterations, and the RMSE against truth is then near the
        odometry's (0.910 of it on this scene), in both packages."""
        n, lms, w = 200, 20, 30
        jcfg = _cfg(n, lms, max_gn_iters=10, exact_jacobians=True)
        kw = dict(odom_info=(100.0,) * 3, solver="tridiag", stall_ratio=0.5,
                  delta_tol=1e-6 * n)

        pt, po, obs = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jlarge.make_large_scene(jcfg, k, n, lms, radius=0.3 * n,
                                              odom_noise=0.1))(
            jax.random.key(0)))
        el = jlarge.window_pairs(obs.valid, window=w)

        def jax_solve(po, obs, el):
            rel = po[1:] - po[:-1]
            rel = rel.at[:, 2].set(jwrap(rel[:, 2]))
            return jlarge.graph_solve_banded(jcfg, po, obs, el, band=w,
                                             rel_odom=rel, **kw)

        want = jax.tree_util.tree_map(np.asarray,
                                      jax.jit(jax_solve)(po, obs, el))
        tobs = graph_observations_from_numpy(obs, device="cpu")
        tpo = _t(po)
        got = tslam.graph_solve_banded(
            graph_config_from(jcfg), tpo, tobs,
            edge_list_from_numpy(el, device="cpu"), band=w,
            rel_odom=_rel_odom(tpo), **kw)
        assert int(got.gn_iters) == int(want.gn_iters) == 4
        np.testing.assert_allclose(got.poses.numpy(), want.poses, atol=1e-4)
        ratio = _rmse(got.poses, _t(pt)) / _rmse(tpo, _t(pt))
        want_ratio = _rmse(_t(want.poses), _t(pt)) / _rmse(tpo, _t(pt))
        assert abs(ratio - want_ratio) < 1e-4
        assert abs(want_ratio - 0.910) < 1e-3


if __name__ == "__main__":
    E2E_FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(E2E_FIXTURE, **jax_scene_draws(**E2E))
