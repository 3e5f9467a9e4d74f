"""The fused PF path's plain twins against the JAX package on the CPU.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it to these
plain twins there); here the plain twins are held to the JAX package's
Pallas kernels run in interpret mode, as ``tests/test_ops.py`` runs them,
and to its ``pf_step_with_noise``.  Each interpret-mode call costs a few
seconds of XLA:CPU compile, so they are few and small.  Tolerances are
stated per test.
"""

import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.filters.pf as jpf
import tpuslam.ops.pf_pallas as jpp
from tpuslam_torch.core.se2 import world_to_robot
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.filters.pf import REF_LANDMARKS
from tpuslam_torch.models.process import circular_step
from tpuslam_torch.ops import _build, pf_cuda
from tpuslam_torch.ops.pf_cuda import (pf_fused_init,
                                       pf_fused_predict_weight,
                                       pf_fused_predict_weight_stats,
                                       pf_fused_rollout,
                                       pf_fused_rollout_plain,
                                       pf_fused_step, pf_fused_step_stats,
                                       pf_fused_to_state)

X0 = np.array([10.0, 0.0, np.pi / 2], np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _cloud(rng, n, spread=(0.3, 0.3, 0.3)):
    return (rng.normal(size=(n, 3)) * spread + X0).astype(np.float32)


def _obs(rng):
    """The landmarks seen from x0, with observation noise."""
    z = world_to_robot(torch.from_numpy(X0), torch.tensor(REF_LANDMARKS))
    return (z.numpy() + rng.normal(size=(5, 2)) * 0.3).astype(np.float32)


def _heavy_state(rng, n, spread=1.0, n_heavy=5):
    """Scattered particles, all weight on the last ``n_heavy``."""
    w = np.full(n, 1e-12)
    w[-n_heavy:] = 0.2
    return (_cloud(rng, n, (spread,) * 3),
            (w / w.sum()).astype(np.float32))


@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_predict_weight_and_stats_match_jax_interpret(rng, flag):
    """K2a and K2b (noise off) against the Pallas kernels over several
    tiles with a ragged tail: particles atol 1e-6; log weights (values of
    a few tens, five summed terms) atol 1e-4; lse/lse2 atol 1e-4; the MAP
    particle atol 1e-6; with the flag the incoming log weights count as
    zeros."""
    n = 100
    cfg = tpf.PfConfig(num_particles=n, weight_mode="log")
    jcfg = jpf.PfConfig(num_particles=n, weight_mode="log")
    p = _cloud(rng, n)
    lw = rng.normal(size=n).astype(np.float32)
    z = _obs(rng)
    jp, jlw, jstats = jpp.pf_fused_predict_weight_stats(
        jcfg, 0, flag, jnp.asarray(p), jnp.asarray(lw), jnp.asarray(z),
        tile_n=64, noise_on=False, interpret=True)
    tp, tlw, tstats = pf_fused_predict_weight_stats(cfg, 0, flag,
                                                    *_t(p, lw, z),
                                                    noise_on=False)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tlw.numpy(), np.asarray(jlw), atol=1e-4)
    np.testing.assert_allclose(tstats[:2].numpy(), np.asarray(jstats[:2]),
                               atol=1e-4)
    np.testing.assert_allclose(tstats[2:5].numpy(), np.asarray(jstats[2:5]),
                               atol=1e-6)
    np.testing.assert_allclose(float(tstats[5]), float(jstats[5]),
                               atol=1e-4)
    if flag == 0.0:
        jp2, jlw2 = jpp.pf_fused_predict_weight(
            jcfg, 0, jnp.asarray(p), jnp.asarray(lw), jnp.asarray(z),
            tile_n=64, noise_on=False, interpret=True)
        tp2, tlw2 = pf_fused_predict_weight(cfg, 0, *_t(p, lw, z),
                                            noise_on=False)
        np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), atol=1e-6)
        np.testing.assert_allclose(tlw2.numpy(), np.asarray(jlw2),
                                   atol=1e-4)
    else:
        _, lw_zero = pf_fused_predict_weight(cfg, 0, torch.from_numpy(p),
                                             torch.zeros(n),
                                             torch.from_numpy(z),
                                             noise_on=False)
        assert torch.equal(tlw, lw_zero)


def test_map_tie_takes_the_highest_index():
    """Equal maximal log weights: the partial row and the combine pick the
    highest flat index (the kernel's rule, whatever the block size)."""
    n = 600
    p_rows = torch.arange(3 * n, dtype=torch.float32).view(3, n)
    lw = torch.zeros(n)
    lw[[3, 500]] = 1.0
    part = pf_cuda._partial_plain(p_rows, lw)
    assert part[0, 6] == 500 and torch.equal(part[0, 3:6], p_rows[:, 500])
    parts = torch.tensor([[0.0, 1, 1, 1, 1, 1, 3, 0],
                          [0.0, 1, 1, 2, 2, 2, 700, 0],
                          [-1.0, 1, 1, 9, 9, 9, 900, 0]])
    out, best = pf_cuda._combine_stats(parts)
    assert float(best) == 700.0 and out[2:5].tolist() == [2.0, 2.0, 2.0]


@pytest.mark.parametrize("case", ["spread", "tied maxima", "NaN log weight",
                                  "all NaN"])
def test_step_stats_layout(rng, case):
    """K2b's ``(10,)`` statistics from the twin, as the kernel writes them:
    ``lse`` and ``lse2`` a float64 logsumexp of the returned log weights
    (rtol 1e-6), the MAP particle the highest index among the non-NaN
    maxima with its log weight and index, and the estimate the MAP
    particle where ``lse`` is finite, else particle 0; a NaN poisons the
    sums but never wins."""
    n = 300
    cfg = tpf.PfConfig(num_particles=n, weight_mode="log")
    p = torch.from_numpy(_cloud(rng, n).T.copy())
    lw = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    if case == "tied maxima":  # a copy of particle 5 at 7 and 250
        p[:, [7, 250]] = p[:, [5]]
        lw[[5, 7, 250]] = 1e5
    elif case == "NaN log weight":
        lw[9] = float("nan")
    elif case == "all NaN":
        lw[:] = float("nan")
    z = torch.from_numpy(_obs(rng))
    p2, lw2, stats = pf_cuda.pf_step_rows(cfg, 0, 0.0, p, lw, z,
                                          noise_on=False)
    assert stats.shape == (10,) and stats.dtype == torch.float32
    lw64 = lw2.double().numpy()
    key = np.where(np.isnan(lw64), -np.inf, lw64)
    best = np.flatnonzero(key == key.max()).max()
    if case in ("NaN log weight", "all NaN"):
        assert torch.isnan(stats[:2]).all()
    else:
        m = lw64.max()
        np.testing.assert_allclose(
            stats[:2].numpy(),
            [m + np.log(np.exp(lw64 - m).sum()),
             2 * m + np.log(np.exp(2 * (lw64 - m)).sum())], rtol=1e-6)
    if case == "all NaN":
        assert torch.equal(stats[7:10], p2[:, 0])
        return
    assert int(stats[6]) == best and stats[5] == lw2[best]
    assert torch.equal(stats[2:5], p2[:, best])
    if case == "tied maxima":
        assert best == 250
    if case == "NaN log weight":
        assert torch.equal(stats[7:10], p2[:, 0])
    else:
        assert torch.equal(stats[7:10], p2[:, best])


def test_step_merge_equals_hist(rng):
    """The fused step with resample_method="merge" selects as "hist" does,
    bit for bit, on the resample branch (noise off)."""
    n = 100
    p, w = _heavy_state(rng, n)
    outs = []
    for method in ("hist", "merge"):
        cfg = tpf.PfConfig(num_particles=n, weight_mode="log",
                           resample_method=method, ess_threshold_frac=0.5)
        fs = pf_fused_init(cfg, tpf.PfState(*_t(X0, p, w)), device="cpu")
        fs2, ess = pf_fused_step_stats(cfg, fs, None, 0, noise_on=False,
                                       offs=0.3, obs_noise=torch.zeros(5, 2))
        assert float(ess) < n * cfg.ess_threshold_frac
        outs.append(fs2)
    assert torch.equal(outs[0].particles, outs[1].particles)
    assert torch.equal(outs[0].log_w, outs[1].log_w)
    # Noise off: every resampled particle is a heavy one moved one step.
    heavy = circular_step(torch.from_numpy(p[-5:]), cfg.vel, cfg.yaw_rate,
                          cfg.dt)
    gap = (outs[0].particles.T[:, None, :] - heavy[None]).abs().sum(-1)
    assert float(gap.min(dim=1).values.max()) < 1e-5


def test_rollout_matches_jax_interpret(rng):
    """Ten noise-free steps from a spread, weighted state with the gate at
    ESS < NP/2, through the merge resample, against the JAX fused rollout
    in interpret mode on the same comb offsets and observation noise:
    truth atol 1e-5, estimates and final particles atol 1e-4."""
    n, n_steps = 64, 10
    kw = dict(num_particles=n, weight_mode="log", resample_method="merge",
              ess_threshold_frac=0.5)
    cfg, jcfg = tpf.PfConfig(**kw), jpf.PfConfig(**kw)
    p = _cloud(rng, n, (0.5, 0.5, 0.2))
    w = np.exp(rng.normal(size=n) * 2.0)
    w = (w / w.sum()).astype(np.float32)
    key = jax.random.key(11)
    jfinal, (jx, jest) = jpp.pf_fused_rollout(
        jcfg, key, n_steps,
        state0=jpf.PfState(jnp.asarray(X0), jnp.asarray(p), jnp.asarray(w)),
        noise_on=False, interpret=True)
    # The JAX rollout's per-step draws: split per step, then (resample,
    # observation); the comb offset is one uniform of the first.
    offs, obs = [], []
    for k in jax.random.split(key, n_steps):
        k_rs, k_obs = jax.random.split(k)
        offs.append(float(jax.random.uniform(k_rs, dtype=jnp.float32)))
        obs.append(np.array(jax.random.normal(k_obs, (5, 2), jnp.float32)
                            * jnp.asarray(jcfg.r_std)))
    state0 = tpf.PfState(*_t(X0, p, w))
    before = pf_cuda.sync_count
    final, (tx, test) = pf_fused_rollout(cfg, None, n_steps, state0,
                                         noise_on=False, device="cpu",
                                         offs=offs, obs_noise=np.stack(obs))
    assert pf_cuda.sync_count - before == 0  # the merge gates on the device
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=1e-4)
    np.testing.assert_allclose(final.particles.numpy(),
                               np.asarray(jfinal.particles), atol=1e-4)
    np.testing.assert_allclose(final.weights.numpy(),
                               np.asarray(jfinal.weights), atol=1e-4)
    # The gate fired on this path: the same run step by step shows it.
    fs = pf_fused_init(cfg, state0, device="cpu")
    fired = 0
    for k in range(n_steps):
        fs, ess = pf_fused_step_stats(cfg, fs, None, 1, noise_on=False,
                                      offs=offs[k], obs_noise=obs[k])
        fired += float(ess) < n * cfg.ess_threshold_frac
    assert fired >= 1
    assert torch.equal(fs.particles.T, final.particles)


def test_truth_cache_keeps_only_the_default_start():
    """Chained rollouts from a caller's own state keep nothing; rollouts
    from ``cfg.x0`` share one entry.  The truth follows the start state
    either way (exact: same ops)."""
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log",
                       resample_method="merge")
    key = ("pf_truth", cfg, 3, torch.device("cpu"))
    _build._CACHE.pop(key, None)
    builds = _build.builds["pf_truth"]
    state, _ = pf_fused_rollout(cfg, torch.Generator().manual_seed(1), 3,
                                device="cpu")
    assert key in _build._CACHE
    assert _build.builds["pf_truth"] == builds + 1
    for _ in range(2):
        x_start = state.x_true
        state, (x_true, _) = pf_fused_rollout(
            cfg, torch.Generator().manual_seed(1), 3, state, device="cpu")
        assert torch.equal(x_true, pf_cuda.truth_table(cfg, x_start, 3)[0])
    pf_fused_rollout(cfg, torch.Generator().manual_seed(2), 3, device="cpu")
    assert _build.builds["pf_truth"] == builds + 1


def test_injected_normals_match_jax_step_with_noise(rng):
    """Noise on, with the same draws: the fused step (normals) against
    ``pf_step_with_noise`` with ``pred_noise = normals * q_std``, over a
    step whose gate fires and one where it does not.  atol 1e-5 on
    particles and estimate (the polynomial sincos is within 2e-7 of the
    builtin trig); weights rtol 1e-3 (float32 exp of log-likelihoods of
    a few tens)."""
    n = 128
    kw = dict(num_particles=n, weight_mode="log", resample_method="merge",
              ess_threshold_frac=0.1)
    cfg, jcfg = tpf.PfConfig(**kw), jpf.PfConfig(**kw)
    p, w = _heavy_state(rng, n, spread=0.05)
    js = jpf.PfState(jnp.asarray(X0), jnp.asarray(p), jnp.asarray(w))
    fs = pf_fused_init(cfg, tpf.PfState(*_t(X0, p, w)), device="cpu")
    fired = []
    for _ in range(2):
        normals = rng.normal(size=(3, n)).astype(np.float32)
        obs = (rng.normal(size=(5, 2)) * cfg.r_std).astype(np.float32)
        offs = float(np.float32(rng.uniform()))
        fs, ess = pf_fused_step_stats(cfg, fs, None, 0, offs=offs,
                                      obs_noise=torch.from_numpy(obs),
                                      normals=torch.from_numpy(normals))
        pred = normals.T * np.asarray(cfg.q_std, np.float32)
        js, jout = jpf.pf_step_with_noise(jcfg, js, jnp.float32(offs),
                                          jnp.asarray(pred),
                                          jnp.asarray(obs))
        fired.append(bool(jout.resampled))
        assert (float(ess) < n * cfg.ess_threshold_frac) == fired[-1]
        np.testing.assert_allclose(float(ess), float(jout.ess), rtol=1e-4)
        st = pf_fused_to_state(cfg, fs)
        np.testing.assert_allclose(st.particles.numpy(),
                                   np.asarray(js.particles), atol=1e-5)
        np.testing.assert_allclose(st.weights.numpy(),
                                   np.asarray(js.weights), rtol=1e-3,
                                   atol=1e-9)
        np.testing.assert_allclose(fs.x_est.numpy(), np.asarray(jout.x_est),
                                   atol=1e-5)
    assert fired == [True, False]


def test_philox_rollout_tracks_truth():
    """The plain twin's own Philox noise, 4096 particles x 100 steps from
    pf_init: the position RMSE lies in bench.py's on-chip band
    (0.02, 0.40) m; the CPU dispatch is the plain twin and launches
    nothing."""
    cfg = tpf.PfConfig(num_particles=4096, weight_mode="log",
                       resample_method="merge")
    before = _build.launches.copy()
    final, (x_true, x_est) = pf_fused_rollout(
        cfg, torch.Generator().manual_seed(3), 100, device="cpu")
    assert _build.launches == before
    rmse = float(torch.sqrt(((x_est[:, :2] - x_true[:, :2]) ** 2)
                            .sum(-1).mean()))
    assert 0.02 < rmse < 0.40, rmse
    assert final.particles.shape == (4096, 3)
    assert torch.isfinite(final.weights).all()
    plain = pf_fused_rollout_plain(cfg, torch.Generator().manual_seed(3),
                                   5, device="cpu")
    again = pf_fused_rollout(cfg, torch.Generator().manual_seed(3), 5,
                             device="cpu")
    assert torch.equal(plain[1][1], again[1][1])


def test_step_api_and_mean_estimate(rng):
    """``pf_fused_step`` keeps the :class:`PfState` shapes; the mean
    estimate is the weighted circular mean of the stepped cloud."""
    n = 50
    cfg = tpf.PfConfig(num_particles=n, weight_mode="log", estimate="mean")
    p = _cloud(rng, n)
    w = np.full(n, 1.0 / n, np.float32)
    state, ess = pf_fused_step(cfg, tpf.PfState(*_t(X0, p, w)), None, 0,
                               noise_on=False, offs=0.5,
                               obs_noise=torch.zeros(5, 2))
    assert state.particles.shape == (n, 3) and state.weights.shape == (n,)
    np.testing.assert_allclose(float(ess), n, rtol=1e-5)
    fs = pf_fused_init(cfg, tpf.PfState(*_t(X0, p, w)), device="cpu")
    fs, _ = pf_fused_step_stats(cfg, fs, None, 0, noise_on=False, offs=0.5,
                                obs_noise=torch.zeros(5, 2))
    want = tpf.pf_estimate(cfg, state.particles, state.weights)
    np.testing.assert_allclose(fs.x_est.numpy(), want.numpy(), atol=1e-5)


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the kernel path is chip_smoke's")
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(RuntimeError, match="CUDA"):
        pf_fused_rollout(cfg, None, 2, device="cuda")


@pytest.mark.parametrize("fn", [pf_fused_init, pf_fused_rollout,
                                pf_fused_rollout_plain])
def test_device_is_required(fn):
    """No default device: leaving it out is an error, not the CPU path."""
    cfg = tpf.PfConfig(num_particles=8)
    with pytest.raises(TypeError, match="device"):
        fn(cfg) if fn is pf_fused_init else fn(cfg, None, 2)


@pytest.mark.parametrize("kwargs,match", [
    ({"normals": torch.zeros(3, 8), "noise_on": False}, "noise_on"),
    ({"normals": torch.zeros(3, 7)}, "normals shape"),
    ({"z": torch.zeros(4, 2)}, "z shape"),
    ({"particles": torch.zeros(7, 3)}, "particles shape"),
])
def test_rejects_bad_arguments(kwargs, match):
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    args = dict(particles=torch.zeros(8, 3), log_w=torch.zeros(8),
                z=torch.zeros(5, 2), noise_on=True)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        pf_fused_predict_weight(cfg, 0, **args)


def test_params_struct_mirrors_cuda_source():
    src = (_build.CSRC_DIR / "pf_step.cu").read_text()
    body = re.search(r"struct PfParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"(\w+)\s*(?:\[[^\]]*\])?\s*[,;]", body)
    assert names == [f[0] for f in pf_cuda._PfParams._fields_]
    assert ctypes.sizeof(pf_cuda._PfParams) == 8 + 3 * 4 + 11 * 4 + 16 * 4
    # The observation std's float32 reciprocals follow it (div_by_const).
    assert names[names.index("sy") + 1:names.index("sy") + 3] == [
        "inv_sx", "inv_sy"]
    # The statistics the kernel writes, as many as the wrapper allocates.
    assert re.search(r"kStatsOut = (\d+)", src).group(1) == str(
        pf_cuda._STATS_LEN)
    # The landmark bound lives with the shared math, which unrolls to it.
    math_src = (_build.CSRC_DIR / "pf_math.cuh").read_text()
    assert re.search(r"kMaxLandmarks = (\d+)", math_src).group(1) == str(
        pf_cuda._MAX_LANDMARKS)
    assert math.isclose(pf_cuda._constants(tpf.PfConfig())["log_norm"],
                        math.log(2 * math.pi * 0.3 * 0.3))
