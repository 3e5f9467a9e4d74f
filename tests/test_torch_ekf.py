"""The port's EKF against the JAX package, the float64 oracle and the
reference's statistical bands.

Tolerances: 1e-5 against the JAX package in float32 at batch 16 (the
same formulas; einsum contraction order and library trig differ by
rounding); the oracle trajectory keeps the JAX package's own bounds
(``tests/test_ekf.py``: 1e-3 on poses and 1e-5 on the covariance after
360 steps); the bands use the statistic and check of
``tests/test_distributional.py``.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
import tpuslam.filters as jf
import tpuslam_torch.filters as tf
from tpuslam_torch.convert import (ekf_config_from, ekf_state_from_numpy,
                                   ekf_state_to_numpy)
from test_distributional import check, wrap

CFG = tf.EkfConfig()
JCFG = jf.EkfConfig()
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "ref_distributions.json"


def _random_state(rng, batch):
    """A batch of plausible mid-rollout states (SPD covariances)."""
    x = rng.normal(size=(3, batch, 3)) * [1.0, 1.0, 0.5] + [10.0, 0.0, 1.0]
    a = rng.normal(size=(batch, 3, 3)) * 0.1
    cov = a @ np.swapaxes(a, -1, -2) + np.eye(3) * 0.05
    return [v.astype(np.float32) for v in (*x, cov)]


def _to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_config_equals_jax_default():
    ported = ekf_config_from(JCFG)
    assert ported == CFG
    for field in CFG.__dataclass_fields__:
        assert getattr(ported, field) == getattr(JCFG, field), field
    assert CFG.vel == JCFG.vel


def test_predict_matches_jax(rng):
    _, _, x_hat, cov = _random_state(rng, 16)
    got = tf.ekf_predict(CFG, *_to_torch(x_hat, cov))
    want = jf.ekf_predict(JCFG, jnp.asarray(x_hat), jnp.asarray(cov))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_update_matches_jax(rng):
    _, _, x_pre, cov = _random_state(rng, 16)
    z = (x_pre[:, :2] + rng.normal(size=(16, 2))).astype(np.float32)
    got = tf.ekf_update(CFG, *_to_torch(x_pre, cov, z))
    want = jf.ekf_update(JCFG, jnp.asarray(x_pre), jnp.asarray(cov),
                         jnp.asarray(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_step_with_noise_matches_jax(rng):
    x_true, x_dr, x_hat, cov = _random_state(rng, 16)
    obs = rng.normal(size=(16, 2)).astype(np.float32)
    dr = (rng.normal(size=(16, 3)) * 0.05).astype(np.float32)
    state = tf.EkfState(*_to_torch(x_true, x_dr, x_hat, cov))
    got_s, got_o = tf.ekf_step_with_noise(CFG, state, *_to_torch(obs, dr))
    want_s, want_o = jf.ekf_step_with_noise(
        JCFG, jf.EkfState(*map(jnp.asarray, (x_true, x_dr, x_hat, cov))),
        jnp.asarray(obs), jnp.asarray(dr))
    for g, w in zip((*got_s, *got_o), (*want_s, *want_o)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trajectory_matches_oracle(rng, dtype):
    """360 steps with injected noise against the float64 numpy oracle."""
    n = 360
    q = np.diag(np.asarray(CFG.q_std)) ** 2
    r = np.diag(np.asarray(CFG.r_std)) ** 2
    obs = rng.normal(size=(n, 2))
    dr = rng.normal(size=(n, 3)) * np.asarray(CFG.q_act_std)
    state = tf.ekf_init(CFG, dtype=dtype, device="cpu")
    xt = np.asarray(CFG.x0)
    xdr, xhat = xt.copy(), xt.copy()
    p = np.diag(np.asarray(CFG.p0_std)) ** 2
    obs_t = torch.from_numpy(obs).to(dtype)
    dr_t = torch.from_numpy(dr).to(dtype)
    for i in range(n):
        state, _ = tf.ekf_step_with_noise(CFG, state, obs_t[i], dr_t[i])
        xt, xdr, _, _, xhat, p = oracles.ekf_step(
            xt, xdr, xhat, p, CFG.vel, CFG.yaw_rate, CFG.dt, q, r, obs[i],
            dr[i])
    np.testing.assert_allclose(state.x_true.numpy(), xt, atol=1e-3)
    np.testing.assert_allclose(state.x_hat.numpy(), xhat, atol=1e-3)
    np.testing.assert_allclose(state.cov.numpy(), p, atol=1e-5)


def test_rollout_shapes_and_determinism():
    final, outs = tf.ekf_rollout(CFG, torch.Generator().manual_seed(0), 50,
                                 device="cpu")
    assert outs.x_true.shape == (50, 3) and outs.cov.shape == (50, 3, 3)
    _, outs2 = tf.ekf_rollout(CFG, torch.Generator().manual_seed(0), 50,
                              device="cpu")
    assert torch.equal(outs.x_pre, outs2.x_pre)
    final, outs = tf.ekf_rollout_batch(
        CFG, torch.Generator().manual_seed(1), 8, 10, dtype=torch.float64,
        device="cpu")
    assert outs.x_true.shape == (8, 10, 3) and final.cov.shape == (8, 3, 3)
    assert outs.x_true.dtype == torch.float64
    nxt, out = tf.ekf_step(CFG, final, torch.Generator().manual_seed(2))
    assert nxt.x_hat.shape == (8, 3) and out.z.shape == (8, 2)


def test_noise_bands():
    """The port's batched rollout, noise from a torch.Generator, falls in
    the live reference's bands (100 seeds x 120 steps)."""
    bands = json.loads(FIXTURE.read_text())
    n_seeds, n_steps = bands["n_seeds"], bands["ekf_steps"]
    _, outs = tf.ekf_rollout_batch(CFG, torch.Generator().manual_seed(4242),
                                   n_seeds, n_steps, device="cpu")
    e = (outs.x_pre - outs.x_true).numpy()
    e[..., 2] = wrap(e[..., 2])
    rmse = np.sqrt((e[..., 0] ** 2 + e[..., 1] ** 2).mean(axis=1))
    sol = np.linalg.solve(outs.cov.numpy(), e[..., None])[..., 0]
    nees = np.einsum("bti,bti->bt", e, sol).mean(axis=1)
    check("ekf.rmse_pos", rmse, bands["ekf"]["rmse_pos"], n_seeds)
    check("ekf.mean_nees", nees, bands["ekf"]["mean_nees"], n_seeds)


def test_state_round_trip_through_numpy(rng):
    x_true, x_dr, x_hat, cov = _random_state(rng, 4)
    jstate = jf.EkfState(*map(jnp.asarray, (x_true, x_dr, x_hat, cov)))
    tstate = ekf_state_from_numpy(jstate, device="cpu")
    assert tstate.cov.shape == (4, 3, 3)
    assert tstate.cov.dtype == torch.float32
    back = ekf_state_to_numpy(tstate)
    for a, b in zip(back, (x_true, x_dr, x_hat, cov)):
        np.testing.assert_array_equal(a, b)
    jax_again = jf.EkfState(*map(jnp.asarray, back))
    nxt, _ = jax.jit(lambda s: jf.ekf_step_with_noise(
        JCFG, s, jnp.zeros((4, 2)), jnp.zeros((4, 3))))(jax_again)
    tnxt, _ = tf.ekf_step_with_noise(CFG, tstate, torch.zeros(4, 2),
                                     torch.zeros(4, 3))
    np.testing.assert_allclose(tnxt.x_hat.numpy(), np.asarray(nxt.x_hat),
                               atol=1e-5)


@pytest.mark.parametrize("fn,args", [(tf.ekf_init, (CFG,)),
                                     (ekf_state_from_numpy, (None,))])
def test_device_is_required(fn, args):
    """No default device: leaving it out is an error, not the CPU path."""
    with pytest.raises(TypeError, match="device"):
        fn(*args)


@pytest.mark.parametrize("fn,args", [
    (tf.ekf_rollout, (CFG, torch.Generator(), 2)),
    (tf.ekf_rollout_batch, (CFG, torch.Generator(), 2, 2))])
def test_rollout_needs_device_and_a_generator_on_it(fn, args):
    """No default device, and a CPU generator with a CUDA device is an
    error, not a CPU run."""
    with pytest.raises(TypeError, match="device"):
        fn(*args)
    with pytest.raises(ValueError, match="generator on cpu"):
        fn(*args, device="cuda")
