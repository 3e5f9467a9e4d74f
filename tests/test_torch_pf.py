"""The particle filter's plain torch path against the JAX package.

Same inputs, made with numpy from a seed, go through ``tpuslam.filters.pf``
and ``tpuslam_torch.filters.pf``; the tolerance is stated in each test.
Index selection is compared exactly: its weights are integer multiples of
``2^-24`` with a sum below 1, so both packages sum them to the same
float32 total.  The noisy batched rollout is held to the reference's
100-seed bands (``tests/fixtures/ref_distributions.json``).
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.filters.pf as jpf
import tpuslam_torch.filters.pf as tpf
from tpuslam_torch.core.se2 import world_to_robot
from tpuslam_torch.convert import (pf_config_from, pf_state_from_numpy,
                                   pf_state_to_numpy)
from test_distributional import check

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "ref_distributions.json"
CFG = tpf.PfConfig()
JCFG = jpf.PfConfig()
X0 = np.array([10.0, 0.0, np.pi / 2], np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _cloud(rng, n, spread=(0.5, 0.5, 0.2)):
    """Particles scattered around x0 and normalized non-uniform weights."""
    p = (rng.normal(size=(n, 3)) * spread + X0).astype(np.float32)
    w = np.exp(rng.normal(size=n) * 2.0)
    return p, (w / w.sum()).astype(np.float32)


def _exact_weights(rng, shape):
    k = rng.integers(0, 1 << 12, shape).astype(np.float64)
    k[..., 3] += 1 << 18  # one heavy particle per row
    return (k / 2 ** 24).astype(np.float32)


def test_config_equals_jax_default():
    ported = pf_config_from(JCFG)
    assert ported == CFG
    for field in CFG.__dataclass_fields__:
        assert getattr(ported, field) == getattr(JCFG, field), field
    assert CFG.vel == JCFG.vel
    assert pf_config_from(jpf.PfConfig(weight_mode="log",
                                       resample_method="merge")) == \
        tpf.PfConfig(weight_mode="log", resample_method="merge")


def test_init_matches_jax():
    got = tpf.pf_init(CFG, (2,), device="cpu")
    want = jpf.pf_init(JCFG, (2,))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn,args", [
    (tpf.pf_init, (CFG,)), (pf_state_from_numpy, (None,)),
    (tpf.pf_rollout, (CFG, torch.Generator(), 2)),
    (tpf.pf_rollout_batch, (CFG, torch.Generator(), 2, 2))])
def test_device_is_required(fn, args):
    """No default device: leaving it out is an error, not the CPU path."""
    with pytest.raises(TypeError, match="device"):
        fn(*args)


@pytest.mark.parametrize("fn,args", [
    (tpf.pf_rollout, (CFG, torch.Generator(), 2)),
    (tpf.pf_rollout_batch, (CFG, torch.Generator(), 2, 2))])
def test_rollout_refuses_a_generator_on_another_device(fn, args):
    """A CPU generator with a CUDA device is an error, not a CPU run."""
    with pytest.raises(ValueError, match="generator on cpu"):
        fn(*args, device="cuda")


@pytest.mark.parametrize("sxy", [0.0, 0.02])
def test_bivariate_normal_pdf_matches_jax(rng, sxy):
    """Independent and correlated cases (float32, rtol 1e-6)."""
    dx, dy = rng.normal(size=(2, 64)).astype(np.float32)
    got = tpf.bivariate_normal_pdf(*_t(dx, dy), 0.3, 0.2, sxy)
    want = jpf.bivariate_normal_pdf(jnp.asarray(dx), jnp.asarray(dy), 0.3,
                                    0.2, sxy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_quantization_and_boundary_law_match_jax(rng):
    """The exact-integer law: equal bit for bit."""
    w = _exact_weights(rng, (3, 500))
    cum, tot = tpf.quantized_cum(torch.from_numpy(w))
    jcum, jtot = jpf.quantized_cum(jnp.asarray(w))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(jcum))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(jtot))
    wq = tpf.quantize_weights_law(torch.from_numpy(w), tot)
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(jpf.quantize_weights_law(jnp.asarray(w),
                                                        jtot)))
    t = tpf.boundary_law(cum, 1.0 / tot, 500, 0.3)
    jt = jpf.boundary_law(jcum, 1.0 / jtot, 500, jnp.float32(0.3))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("method", ["search", "hist", "merge"])
def test_resample_indices_match_jax(rng, method):
    """Selection equal to the JAX package's index for index, per row of a
    batch and for several comb offsets."""
    w = _exact_weights(rng, (4, 300))
    offs = np.float32([0.0, 0.25, 0.5, 0.999])
    got = tpf.resample_indices_from_offs(torch.from_numpy(offs),
                                         torch.from_numpy(w), method)
    for row in range(4):
        want = jpf.resample_indices_from_offs(jnp.float32(offs[row]),
                                              jnp.asarray(w[row]), method)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(want))
        single = tpf.resample_indices_from_offs(float(offs[row]),
                                                torch.from_numpy(w[row]),
                                                method)
        assert torch.equal(single, got[row])


def test_systematic_resample_from_generator(rng):
    """The generator draws the offset: same seed, same draw; the heavy
    particles survive and the weights come back uniform."""
    p, _ = _cloud(rng, 200)
    w = np.zeros(200, np.float32)
    w[[7, 150]] = [0.25, 0.75]
    out, wu = tpf.systematic_resample(torch.Generator().manual_seed(1),
                                      *_t(p, w))
    again, _ = tpf.systematic_resample(torch.Generator().manual_seed(1),
                                       *_t(p, w))
    assert torch.equal(out, again)
    assert torch.equal(wu, torch.full((200,), 1.0 / 200))
    picked = {tuple(r) for r in out.numpy().tolist()}
    assert picked == {tuple(p[7].tolist()), tuple(p[150].tolist())}
    assert (out.numpy() == p[150]).all(axis=1).sum() in (149, 150, 151)


def test_weight_helpers_match_jax(rng):
    """ESS, normalization with its NaN reset, log weights (rtol 1e-6)."""
    _, w = _cloud(rng, 300)
    np.testing.assert_allclose(
        tpf.effective_sample_size(torch.from_numpy(w)).numpy(),
        np.asarray(jpf.effective_sample_size(jnp.asarray(w))), rtol=1e-6)
    raw = np.abs(rng.normal(size=(2, 300))).astype(np.float32)
    raw[1] = np.nan
    np.testing.assert_allclose(
        tpf._normalize(CFG, torch.from_numpy(raw)).numpy(),
        np.asarray(jpf._normalize(JCFG, jnp.asarray(raw))), rtol=1e-6)
    lw = (rng.normal(size=(3, 300)) * 5).astype(np.float32)
    lw[2, 0] = np.nan
    lse = np.float32([[2.0], [np.inf], [1.0]])
    np.testing.assert_allclose(
        tpf.weights_from_log(CFG, *_t(lw, lse)).numpy(),
        np.asarray(jpf.weights_from_log(JCFG, jnp.asarray(lw),
                                        jnp.asarray(lse))), rtol=1e-6)


@pytest.mark.parametrize("mode", ["linear", "log"])
def test_likelihood_matches_jax(rng, mode):
    """Per-particle likelihood of one observation, batched over two
    filters, near the true pose (log: atol 1e-4 on values of a few tens;
    linear: rtol 1e-4, an ulp of an exponent of up to a few hundred
    carried through exp)."""
    p = np.stack([_cloud(rng, 100)[0] for _ in range(2)])
    z = world_to_robot(torch.from_numpy(X0), torch.tensor(CFG.landmarks))
    z = (z.numpy() + rng.normal(size=(2, 5, 2)) * 0.3).astype(np.float32)
    cfg, jcfg = (tpf.PfConfig(weight_mode=mode),
                 jpf.PfConfig(weight_mode=mode))
    got = tpf.pf_likelihood(cfg, *_t(p, z)).numpy()
    for b in range(2):
        want = np.asarray(jpf.pf_likelihood(jcfg, jnp.asarray(p[b]),
                                            jnp.asarray(z[b])))
        if mode == "log":
            np.testing.assert_allclose(got[b], want, atol=1e-4)
        else:
            np.testing.assert_allclose(got[b], want, rtol=1e-4,
                                       atol=1e-30)


@pytest.mark.parametrize("estimate", ["map", "mean"])
def test_estimate_matches_jax(rng, estimate):
    """MAP (the first maximum on a tie) and the circular weighted mean
    (atol 1e-5)."""
    p, w = _cloud(rng, 200)
    w[[5, 9]] = w.max() * 2  # a tie: both packages take index 5
    got = tpf.pf_estimate(tpf.PfConfig(estimate=estimate), *_t(p, w))
    want = jpf.pf_estimate(jpf.PfConfig(estimate=estimate), jnp.asarray(p),
                           jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode,method", [("linear", "search"),
                                         ("log", "hist")])
def test_step_with_noise_matches_jax(rng, mode, method):
    """Six steps on the same noise from a spread cloud whose gate is set
    to fire often (ESS < NP/2); the gate fires on at least one step and
    both packages agree on every step (gate exact; particles atol 1e-5;
    weights rtol 1e-3, from float32 exp of log-likelihoods near -50)."""
    n = 256
    kw = dict(num_particles=n, weight_mode=mode, resample_method=method,
              ess_threshold_frac=0.5)
    cfg, jcfg = tpf.PfConfig(**kw), jpf.PfConfig(**kw)
    p, w = _cloud(rng, n)
    ts = tpf.PfState(*_t(X0, p, w))
    js = jpf.PfState(jnp.asarray(X0), jnp.asarray(p), jnp.asarray(w))
    fired = 0
    for _ in range(6):
        pred = (rng.normal(size=(n, 3)) * cfg.q_std).astype(np.float32)
        obs = (rng.normal(size=(5, 2)) * cfg.r_std).astype(np.float32)
        offs = np.float32(rng.uniform())
        ts, tout = tpf.pf_step_with_noise(cfg, ts, torch.tensor(offs),
                                          *_t(pred, obs))
        js, jout = jpf.pf_step_with_noise(jcfg, js, jnp.float32(offs),
                                          jnp.asarray(pred),
                                          jnp.asarray(obs))
        assert bool(tout.resampled) == bool(jout.resampled)
        fired += bool(tout.resampled)
        np.testing.assert_allclose(ts.x_true.numpy(), np.asarray(js.x_true),
                                   atol=1e-5)
        np.testing.assert_allclose(ts.particles.numpy(),
                                   np.asarray(js.particles), atol=1e-5)
        np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights),
                                   rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(float(tout.ess), float(jout.ess),
                                   rtol=1e-4)
        np.testing.assert_allclose(tout.x_est.numpy(), np.asarray(jout.x_est),
                                   atol=1e-5)
        assert int(tout.max_idx) == int(jout.max_idx)
    assert fired >= 1


def test_step_and_rollout_shapes():
    cfg = tpf.PfConfig(num_particles=64, weight_mode="log")
    gen = torch.Generator().manual_seed(0)
    state, out = tpf.pf_step(cfg, tpf.pf_init(cfg, device="cpu"), gen)
    assert state.particles.shape == (64, 3) and out.x_est.shape == (3,)
    final, outs = tpf.pf_rollout(cfg, gen, 5, device="cpu")
    assert outs.x_true.shape == (5, 3) and outs.particles.shape == (5, 0)
    _, kept = tpf.pf_rollout(cfg, gen, 3, keep_particles=True, device="cpu")
    assert kept.particles.shape == (3, 64, 3)
    assert kept.weights.shape == (3, 64)
    again = tpf.pf_rollout(cfg, torch.Generator().manual_seed(9), 5,
                           device="cpu")
    same = tpf.pf_rollout(cfg, torch.Generator().manual_seed(9), 5,
                          device="cpu")
    assert torch.equal(again[1].x_est, same[1].x_est)


def test_rollout_batch_in_reference_bands():
    """100 seeds x 60 steps x 1000 particles, batched, against the
    reference's PF bands, with the rule of tests/test_distributional.py."""
    bands = json.loads(FIXTURE.read_text())
    n_seeds, n_steps = bands["n_seeds"], bands["pf_steps"]
    final, outs = tpf.pf_rollout_batch(CFG, torch.Generator().manual_seed(7),
                                       n_seeds, n_steps, device="cpu")
    assert outs.x_est.shape == (n_seeds, n_steps, 3)
    assert outs.particles.shape == (n_seeds, n_steps, 0)
    e = (outs.x_est[..., :2] - outs.x_true[..., :2]).numpy()
    rmse = np.sqrt((e ** 2).sum(-1).mean(axis=1))
    fires = outs.resampled.numpy().sum(axis=1)
    ess_final = tpf.effective_sample_size(final.weights).numpy()
    ess = np.concatenate([outs.ess.numpy()[:, 1:], ess_final[:, None]],
                         axis=1)
    check("pf.rmse_pos", rmse, bands["pf"]["rmse_pos"], n_seeds)
    check("pf.fire_count", fires, bands["pf"]["fire_count"], n_seeds)
    check("pf.mean_ess_frac", (ess / CFG.num_particles).mean(axis=1),
          bands["pf"]["mean_ess_frac"], n_seeds)


def test_state_round_trip_through_numpy(rng):
    p, w = _cloud(rng, 32)
    jstate = jpf.PfState(jnp.asarray(X0), jnp.asarray(p), jnp.asarray(w))
    tstate = pf_state_from_numpy(jstate, device="cpu")
    assert tstate.particles.shape == (32, 3)
    assert tstate.weights.dtype == torch.float32
    for a, b in zip(pf_state_to_numpy(tstate), (X0, p, w)):
        np.testing.assert_array_equal(a, b)
