"""The batched PF (K4) path's plain twin against the JAX package on the CPU.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it to this
plain twin there, selection bit for bit); here the twin is held to the
JAX package's ``pf_batch_step`` with its Pallas kernel in interpret mode
and ``noise_on=False`` (``pltpu.prng_*`` has no CPU lowering), on the
same observation noise.  States cross between the packages with
``tpuslam_torch.convert``.  Each interpret-mode configuration costs a
couple of seconds of XLA:CPU compile, so they are few and small.
Tolerances are stated per test.
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
import tpuslam.ops.pf_batch_pallas as jpb
from tpuslam_torch import convert
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.ops import _build
from tpuslam_torch.ops import pf_batch_cuda as pb

X0 = np.array([10.0, 0.0, np.pi / 2], np.float32)
N_LM = 5


def _cfgs(**kw):
    kw.setdefault("weight_mode", "log")
    return tpf.PfConfig(**kw), jpf.PfConfig(**kw)


def _jax_state(jcfg, parts, lw):
    """The JAX package's flat batched state holding ``parts`` (B, n, 3)
    and log weights ``lw`` (B, n), with consistent normalizers."""
    b, n = lw.shape
    st = jpb.pf_batch_init(jcfg, b)
    p_pad = st.particles.shape[1] // b
    p_rows = np.zeros((3, b, p_pad), np.float32)
    p_rows[:, :, :n] = parts.transpose(2, 0, 1)
    lw_rows = np.full((b, p_pad), -np.inf, np.float32)
    lw_rows[:, :n] = lw
    return jpb.pf_batch_refresh_stats(jcfg, st._replace(
        particles=jnp.asarray(p_rows.reshape(3, -1)),
        log_w=jnp.asarray(lw_rows.reshape(1, -1))))


def _spread(rng, b, n, sigma):
    """Clouds around x0 and log weights of spread ``sigma`` (per filter)."""
    parts = (X0 + rng.normal(size=(b, n, 3)) * (0.5, 0.5, 0.2)
             ).astype(np.float32)
    lw = (rng.normal(size=(b, n)) * np.asarray(sigma)[:, None]
          ).astype(np.float32)
    return parts, lw


def _obs_noise(jcfg, key, b):
    """The scaled observation noise ``pf_batch_step`` draws from ``key``."""
    return np.array(jax.random.normal(key, (b, N_LM, 2), jnp.float32)
                    * jnp.asarray(jcfg.r_std, jnp.float32))


def _step_both(cfg, jcfg, jst, key, **kw):
    """One step of the JAX package (interpret mode, noise off) and one of
    the port's twin from the same state and observation noise."""
    b = jst.lse.shape[0]
    n = cfg.num_particles
    jst2, jout = jpb.pf_batch_step(jcfg, jst, key, 0, noise_on=False,
                                   interpret=True)
    st = convert.pf_batch_state_from_numpy(jst, n, device="cpu")
    st2, out = pb.pf_batch_step(cfg, st, None, 0, noise_on=False,
                                obs_noise=_obs_noise(jcfg, key, b), **kw)
    return (convert.pf_batch_state_from_numpy(jst2, n, device="cpu"), jout,
            st2, out)


def _assert_step_close(want, jout, got, out):
    """Particles atol 1e-5 (positions near 10 m, float32 trig), log
    weights rtol 1e-5 + atol 1e-4 (five landmark terms of up to a few
    hundred), normalizers the same, MAP estimate atol 1e-5, gate flags and
    ESS (rtol 1e-6) as the JAX package."""
    np.testing.assert_allclose(got.particles.numpy(),
                               want.particles.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.log_w.numpy(), want.log_w.numpy(),
                               rtol=1e-5, atol=1e-4)
    for name in ("lse", "lse2"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out.x_est.numpy(), np.asarray(jout.x_est),
                               atol=1e-5)
    np.testing.assert_allclose(out.ess.numpy(), np.asarray(jout.ess),
                               rtol=1e-6)
    assert out.resampled.tolist() == np.asarray(jout.resampled).tolist()
    assert out.bad.tolist() == np.asarray(jout.bad).tolist()


def test_gate_closed_step_matches_jax_interpret(rng):
    """No filter fires (default gate, ESS near n): predict and weight of
    every filter on its own observation."""
    b, n = 4, 100
    cfg, jcfg = _cfgs(num_particles=n)
    parts, lw = _spread(rng, b, n, [0.2, 0.5, 0.8, 1.0])
    want, jout, got, out = _step_both(cfg, jcfg, _jax_state(jcfg, parts, lw),
                                      jax.random.key(5))
    assert not out.resampled.any()
    _assert_step_close(want, jout, got, out)


def test_forced_gate_selects_exactly(rng):
    """The gate forced (``ess_threshold_frac=2.0``), weights that are exact
    binary fractions (8 heavy particles of 1/8): the twin's selection is
    the numpy comb ``t = ceil(n cum - 0.5)`` exactly, and its particles and
    weights equal the JAX kernel's (after ``tests/test_ops.py``'s
    in-tile exactness test)."""
    b, n = 2, 128
    cfg, jcfg = _cfgs(num_particles=n, ess_threshold_frac=2.0)
    parts = np.broadcast_to(rng.normal(size=(n, 3)).astype(np.float32),
                            (b, n, 3)).copy()
    heavy = [3, 17, 40, 41, 77, 90, 100, 127]
    lw = np.full((b, n), -np.inf, np.float32)
    lw[:, heavy] = np.log(1.0 / 8.0)
    jst = _jax_state(jcfg, parts, lw)
    want, jout, got, out = _step_both(cfg, jcfg, jst, jax.random.key(2))
    assert out.resampled.all()
    _assert_step_close(want, jout, got, out)

    st = convert.pf_batch_state_from_numpy(jst, n, device="cpu")
    z = torch.zeros(b, N_LM, 2)
    rows = pb.pf_batch_step_rows(cfg, 0, st.particles, st.log_w, st.lse,
                                 st.lse2, z, noise_on=False, with_sel=True)
    w = np.zeros(n)
    w[heavy] = 1.0 / 8.0
    t = np.clip(np.ceil(n * np.cumsum(w) - 0.5), 0, n).astype(int)
    t[-1] = n
    want_sel = np.searchsorted(t, np.arange(n), side="right")
    assert (rows.sel.numpy() == want_sel[None]).all()


def test_bad_filter_resets_to_uniform(rng):
    """A filter whose normalizers are NaN is ``bad``: it does not fire,
    its log weights restart at ``-log n`` and its next state is finite;
    the others step as the JAX package's."""
    b, n = 4, 100
    cfg, jcfg = _cfgs(num_particles=n)
    parts, lw = _spread(rng, b, n, [0.5] * b)
    lw[2, 7] = np.nan
    want, jout, got, out = _step_both(cfg, jcfg, _jax_state(jcfg, parts, lw),
                                      jax.random.key(9))
    assert out.bad.tolist() == [False, False, True, False]
    assert not out.resampled.any()
    assert torch.isfinite(got.log_w).all() and torch.isfinite(got.lse).all()
    _assert_step_close(want, jout, got, out)


def test_rollout_matches_jax_steps(rng):
    """25 noise-free steps of four filters from spread, skewed clouds with
    the gate at ESS < n/2, against the JAX step looped on the same
    observation noise (each from its own final state).

    The two packages compute ``exp`` and float32 sums with different
    code, so a quantized weight ``round(w 2^20)`` can move by one and a
    comb point by one slot; that moves one particle.  So the test allows
    up to 1% of the particles and estimates to differ and holds the rest
    at atol 1e-4; the firing pattern must be the same."""
    b, n, n_steps = 4, 200, 25
    cfg, jcfg = _cfgs(num_particles=n, ess_threshold_frac=0.5)
    parts, lw = _spread(rng, b, n, [0.5, 1.0, 1.5, 2.0])
    jst = _jax_state(jcfg, parts, lw)
    state0 = convert.pf_batch_state_from_numpy(jst, n, device="cpu")
    keys = jax.random.split(jax.random.key(3), n_steps)
    obs = np.stack([_obs_noise(jcfg, k, b) for k in keys])
    j_est, j_fire = [], []
    for k in keys:
        jst, jout = jpb.pf_batch_step(jcfg, jst, k, 0, noise_on=False,
                                      interpret=True)
        j_est.append(np.asarray(jout.x_est))
        j_fire.append(np.asarray(jout.resampled))
    final, outs = pb.pf_batch_rollout(cfg, None, b, n_steps, noise_on=False,
                                      device="cpu", state0=state0,
                                      obs_noise=obs)
    fire = outs.resampled.numpy()
    assert (fire == np.stack(j_fire)).all()
    assert 0 < fire.sum() < fire.size
    est_off = np.abs(outs.x_est.numpy() - np.stack(j_est)).max(-1) > 1e-4
    assert est_off.mean() <= 0.01, est_off.mean()
    want = convert.pf_batch_state_from_numpy(jst, n, device="cpu")
    p_off = (final.particles - want.particles).abs().amax(0) > 1e-4
    assert float(p_off.float().mean()) <= 0.01
    np.testing.assert_allclose(final.lse.numpy(), want.lse.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_philox_rollout_tracks_truth():
    """The twin's own Philox noise, 16 filters x 1000 particles x 60 steps
    from ``pf_batch_init`` (under torch's 32768-element grain, so every op
    stays on one thread beside the other test workers): the position RMSE
    over every filter and step lies in ``bench.py``'s on-chip band
    (0.02, 0.50) m; the CPU dispatch launches nothing and the rollout is
    reproducible."""
    cfg = tpf.PfConfig(num_particles=1000, weight_mode="log")
    before = _build.launches.copy()
    final, outs = pb.pf_batch_rollout(cfg, torch.Generator().manual_seed(4),
                                      16, 60, device="cpu")
    assert _build.launches == before
    e = outs.x_est[..., :2] - outs.x_true[:, None, :2]
    rmse = float(torch.sqrt((e ** 2).sum(-1).mean()))
    assert 0.02 < rmse < 0.50, rmse
    assert outs.resampled.any() and not outs.bad.any()
    assert final.particles.shape == (3, 16, 1000)
    again = pb.pf_batch_rollout(cfg, torch.Generator().manual_seed(4), 16,
                                60, device="cpu")
    assert torch.equal(again[1].x_est, outs.x_est)


def test_philox_offsets_and_normals_are_the_kernels_stream():
    """With Philox noise the comb offset of filter f comes from the
    counter ``(0, f, 1, 0)`` and its particles' normals from
    ``(j, f, 0, 0)``: injecting exactly those reproduces the step."""
    b, n = 3, 50
    cfg = tpf.PfConfig(num_particles=n, weight_mode="log",
                       ess_threshold_frac=2.0)
    g = torch.Generator().manual_seed(0)
    particles = (torch.tensor(X0)[:, None, None]
                 + 0.3 * torch.randn((3, b, n), generator=g))
    log_w = torch.randn((b, n), generator=g)
    st = pb.pf_batch_refresh_stats(cfg, pb.PfBatchState(
        torch.tensor(X0), particles, log_w, None, None))
    z = torch.randn((b, N_LM, 2), generator=g)
    seed = 123456789
    args = (cfg, seed, particles, log_w, st.lse, st.lse2, z)
    philox = pb.pf_batch_step_rows(*args)
    from tpuslam_torch.ops.fastmath import normals_from_bits, philox4x32
    j = torch.arange(n)[None]
    f = torch.arange(b)[:, None]
    a = philox4x32(j, f, 0, 0, seed, 0)
    n0, n1 = normals_from_bits(a[0], a[1])
    n2, _ = normals_from_bits(a[2], a[3])
    offs = (philox4x32(0, torch.arange(b), 1, 0, seed, 0)[0] >> 8
            ).to(torch.float32) / (1 << 24)
    injected = pb.pf_batch_step_rows(*args, normals=torch.stack([n0, n1, n2]),
                                     offs=offs)
    assert torch.equal(philox.particles, injected.particles)
    assert torch.equal(philox.log_w, injected.log_w)


@pytest.mark.parametrize("r", [1, 8])
def test_state_converters_round_trip(rng, r):
    """JAX states flat (``sub_rows=1``) and packed (``sub_rows=8``, both
    rollouts' default) read into the port's ``(3, B, n)`` layout without
    their padding; written back, they are the flat padded JAX layout,
    which the JAX step accepts."""
    b, n = 3, 1000
    cfg, jcfg = _cfgs(num_particles=n)
    st = jpb.pf_batch_init(jcfg, b, sub_rows=r)
    p = rng.normal(size=st.particles.shape).astype(np.float32)
    lw = rng.normal(size=st.log_w.shape).astype(np.float32)
    flat_p = np.asarray(jpb.flat_batch_rows(jnp.asarray(p), b, r))
    flat_lw = np.asarray(jpb.flat_batch_rows(jnp.asarray(lw), b, r))
    p_pad = flat_lw.shape[1] // b
    jst = st._replace(particles=jnp.asarray(p), log_w=jnp.asarray(lw))
    port = convert.pf_batch_state_from_numpy(jst, n, device="cpu")
    assert port.particles.shape == (3, b, n) and port.log_w.shape == (b, n)
    np.testing.assert_array_equal(
        port.particles.numpy(), flat_p.reshape(3, b, p_pad)[:, :, :n])
    np.testing.assert_array_equal(port.log_w.numpy(),
                                  flat_lw.reshape(b, p_pad)[:, :n])
    back = convert.pf_batch_state_to_numpy(port)
    assert back.particles.shape == (3, b * 1024)
    back_lw = back.log_w.reshape(b, 1024)
    np.testing.assert_array_equal(back_lw[:, :n], port.log_w.numpy())
    assert np.isneginf(back_lw[:, n:]).all()
    again = convert.pf_batch_state_from_numpy(back, n, device="cpu")
    assert torch.equal(again.particles, port.particles)
    init = pb.pf_batch_init(cfg, b, device="cpu")
    jinit = convert.pf_batch_state_from_numpy(
        jpb.pf_batch_init(jcfg, b, sub_rows=r), n, device="cpu")
    for name in ("x_true", "particles", "log_w", "lse", "lse2"):
        np.testing.assert_allclose(getattr(init, name).numpy(),
                                   getattr(jinit, name).numpy(), rtol=1e-6,
                                   err_msg=name)


def test_refresh_stats_matches_jax(rng):
    b, n = 3, 100
    cfg, jcfg = _cfgs(num_particles=n)
    parts, lw = _spread(rng, b, n, [0.5, 2.0, 4.0])
    jst = _jax_state(jcfg, parts, lw)
    st = convert.pf_batch_state_from_numpy(jst, n, device="cpu")
    st = pb.pf_batch_refresh_stats(cfg, st._replace(lse=None, lse2=None))
    np.testing.assert_allclose(st.lse.numpy(), np.asarray(jst.lse),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.lse2.numpy(), np.asarray(jst.lse2),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", [pb.pf_batch_init, pb.pf_batch_rollout])
def test_device_is_required(fn):
    """No default device: leaving it out is an error, not the CPU path."""
    cfg = tpf.PfConfig(num_particles=8)
    with pytest.raises(TypeError, match="device"):
        fn(cfg, 2) if fn is pb.pf_batch_init else fn(cfg, None, 2, 2)


def test_generator_must_lie_on_the_rollout_device():
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(ValueError, match="generator on cpu"):
        pb.pf_batch_rollout(cfg, torch.Generator(), 2, 2, device="cuda")


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the kernel path is chip_smoke's")
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.pf_batch_rollout(cfg, None, 2, 2, device="cuda")


@pytest.mark.parametrize("kwargs,match", [
    ({"normals": torch.zeros(3, 2, 8), "noise_on": False}, "noise_on"),
    ({"normals": torch.zeros(3, 2, 7)}, "normals shape"),
    ({"z": torch.zeros(2, 4, 2)}, "z shape"),
    ({"offs": torch.zeros(3)}, "offs shape"),
    ({"lse": torch.zeros(2, dtype=torch.float64)}, "lse dtype"),
])
def test_rejects_bad_arguments(kwargs, match):
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    args = dict(particles=torch.zeros(3, 2, 8), log_w=torch.zeros(2, 8),
                lse=torch.zeros(2), lse2=torch.zeros(2),
                z=torch.zeros(2, N_LM, 2), noise_on=True)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        pb.pf_batch_step_rows(cfg, 0, **args)


def _struct_fields(src: str, name: str) -> list:
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"(\w+)\s*(?:\[[^\]]*\])?\s*[,;]", body)


def test_structs_mirror_cuda_source():
    """The ``ctypes`` mirrors of K4's parameter and buffer structs list
    the fields of ``csrc/pf_batch.cu`` in its order, at its sizes."""
    src = (_build.CSRC_DIR / "pf_batch.cu").read_text()
    assert _struct_fields(src, "PfBatchParams") == [
        f[0] for f in pb._PfBatchParams._fields_]
    assert _struct_fields(src, "PfBatchBuffers") == [
        f[0] for f in pb._PfBatchBuffers._fields_]
    assert ctypes.sizeof(pb._PfBatchParams) == 4 * 4 + 12 * 4 + 16 * 4
    assert [f[0] for f in pb._F32[5:9]] == ["sx", "sy", "inv_sx",
                                          "inv_sy"]
    assert ctypes.sizeof(pb._PfBatchBuffers) == 16 * 8
    assert re.search(r"kMaxN = (\d+)", src).group(1) == str(
        pb._MAX_BATCH_N)
    params = pb._PfBatchParams(n=1000, ess_min=10.0,
                               neg_log_n=-math.log(1000.0))
    assert math.isclose(params.neg_log_n, -math.log(1000.0), rel_tol=1e-6)


def test_host_sync_counter_runs_without_cuda():
    """``count_host_syncs`` wraps a rollout on any host; with no CUDA
    nothing synchronises and the count stays 0 (the card's count is
    ``chip_smoke.py``'s, against an ``.item()`` control)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the count is chip_smoke's")
    from tpuslam_torch.utils import count_host_syncs

    cfg = tpf.PfConfig(num_particles=16, weight_mode="log")
    with count_host_syncs() as syncs:
        pb.pf_batch_rollout(cfg, torch.Generator().manual_seed(0), 2, 3,
                            device="cpu")
    assert syncs.count == 0
