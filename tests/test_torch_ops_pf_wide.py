"""The wide batched PF (K5a, the segmented K3b, K5b) path's plain twins
against the JAX package on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them to
these twins there, boundaries and copies bit for bit); here the twins are
held to the JAX package's ``pf_batch_wide_step`` with its Pallas kernels
in interpret mode and ``noise_on=False``, on the same comb offsets and
observation noise, and the selection to its ``slot_boundaries_from_wq``
and ``decode_indices`` on the same quantized integers; K5a's twin's
fixed-order row sum to a numpy loop of the kernel's order.  Every JAX step
here shares one configuration and one shape, so the module compiles it
once.  Tolerances are stated per test.
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
import tpuslam.ops.resample_pallas as jrs
from tpuslam_torch import convert
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.ops import _build, resample_cuda
from tpuslam_torch.ops import pf_batch_cuda as pb

B, N, TILE = 6, 1000, 256
KW = dict(num_particles=N, weight_mode="log")
CFG, JCFG = tpf.PfConfig(**KW), jpf.PfConfig(**KW)
N_LM = 5


def _mixed_state(rng, skew_ids, bad_ids=()):
    """The JAX package's flat wide state (``tests/test_ops.py``'s mixed
    state): spread clouds, uniform log weights except the skewed filters
    (the gate fires for those), NaN normalizers on the bad ones."""
    w_tiles, np_ = jpb._wide_dims(JCFG, TILE)
    st = jpb.pf_batch_wide_init(JCFG, B, TILE)
    p = np.asarray(st.particles).copy()
    p += rng.normal(size=p.shape) * 0.3
    lw = np.asarray(st.log_w).copy()
    lse = np.asarray(st.lse).copy()
    lse2 = np.asarray(st.lse2).copy()
    for f in skew_ids:
        vals = rng.normal(size=N) * 8.0
        lw[0, f * np_:f * np_ + N] = vals
        m = vals.max()
        lse[f] = m + np.log(np.exp(vals - m).sum())
        lse2[f] = 2 * m + np.log(np.exp(2 * (vals - m)).sum())
    lse[list(bad_ids)] = np.nan
    return st._replace(particles=jnp.asarray(p.astype(np.float32)),
                       log_w=jnp.asarray(lw), lse=jnp.asarray(lse),
                       lse2=jnp.asarray(lse2))


def _draws(key):
    """The comb offsets and scaled observation noise
    ``pf_batch_wide_step`` draws from ``key``."""
    k_rs, k_obs = jax.random.split(key)
    offs = np.array(jax.random.uniform(k_rs, (B,), jnp.float32))
    noise = np.array(jax.random.normal(k_obs, (B, N_LM, 2), jnp.float32)
                     * jnp.asarray(JCFG.r_std, jnp.float32))
    return offs, noise


def _jax_step(jst, key):
    return jpb.pf_batch_wide_step(JCFG, jst, key, 1, tile_n=TILE,
                                  noise_on=False, interpret=True)


def _port(jst):
    return convert.pf_batch_wide_state_from_numpy(jst, N, device="cpu")


def _assert_close(want, jout, got, out, ess_rtol=1e-6):
    """One slot may move where the packages' float32 sums and ``exp``
    round a quantized weight differently (see ``_share_off``); everything
    else holds at particles atol 1e-5, log weights rtol 1e-5 + atol 1e-4,
    normalizers rtol 1e-4, estimates atol 1e-5; the ESS from the same
    carried normalizers at ``ess_rtol``."""
    assert out.resampled.tolist() == np.asarray(jout.resampled).tolist()
    assert out.bad.tolist() == np.asarray(jout.bad).tolist()
    np.testing.assert_allclose(out.ess.numpy(), np.asarray(jout.ess),
                               rtol=ess_rtol)
    assert _share_off(got.particles, want.particles, 1e-5) <= 0.01
    lw_off = ~np.isclose(got.log_w.numpy(), want.log_w.numpy(), rtol=1e-5,
                         atol=1e-4)
    assert lw_off.mean() <= 0.01
    np.testing.assert_allclose(got.lse.numpy(), want.lse.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.lse2.numpy(), want.lse2.numpy(),
                               rtol=1e-4)
    est_off = np.abs(out.x_est.numpy() - np.asarray(jout.x_est)).max(-1)
    assert (est_off > 1e-5).mean() <= 0.2, est_off


def _share_off(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    """The share of particles (any coordinate) further apart than
    ``atol``: a quantized weight that rounds the other way on one side
    moves one comb point by one slot, that is one particle."""
    return float(((a - b).abs().amax(0) > atol).float().mean())


def test_mixed_firing_step_matches_jax_interpret(rng):
    """Three of six filters fire (ESS far below 1%), the others keep their
    particles: particles, log weights, normalizers and estimates as the
    JAX package's step, firing and idle filters mixed."""
    jst = _mixed_state(rng, (1, 4, 5))
    key = jax.random.key(11)
    jst2, jout = _jax_step(jst, key)
    offs, noise = _draws(key)
    st2, out = pb.pf_batch_wide_step(CFG, _port(jst), None, 1,
                                     noise_on=False, obs_noise=noise,
                                     offs=offs)
    assert out.resampled.tolist() == [False, True, False, False, True, True]
    _assert_close(_port(jst2), jout, st2, out)


def test_selection_equals_slot_boundaries_decode(rng):
    """On the same quantized integers and offsets, K5a's twin gives the
    JAX ``slot_boundaries_from_wq`` boundaries and the segmented expand's
    twin the particles of its ``decode_indices``, bit for bit, each slot
    from its own filter; idle slots stay 0."""
    fire = torch.tensor([False, True, False, False, True, True])
    jst = _mixed_state(rng, (1, 4, 5))
    st = _port(jst)
    offs = torch.rand(B, generator=torch.Generator().manual_seed(1))
    slots = pb.wide_boundary(st.log_w, st.lse, fire, offs)
    assert slots.fids.tolist() == [1, 4, 5, 0, 0, 0]
    assert slots.valid.tolist() == [True] * 3 + [False] * 3
    assert slots.src.tolist() == [0, 0, 1, 1, 1, 2]
    t = slots.t_hi
    expanded = resample_cuda.resample_expand_seg(st.particles, t, slots.fids,
                                                 slots.valid)
    cum, _ = pb.wide_prefix_plain(st.log_w, st.lse)
    wq = torch.diff(cum, dim=1, prepend=torch.zeros(B, 1))
    for s, f in enumerate((1, 4, 5)):
        want_t = jrs.slot_boundaries_from_wq(jnp.asarray(wq[f][None]), N,
                                             jnp.float32(offs[f]))
        assert np.array_equal(t[s].numpy(), np.asarray(want_t)[0])
        idx = np.array(jrs.decode_indices(want_t, N))
        np.testing.assert_array_equal(expanded[:, s].numpy(),
                                      st.particles[:, f, idx].numpy())
    assert not expanded[:, 3:].any() and not t[3:].any()
    # A slot expands exactly as the single-filter expand of its filter.
    single = resample_cuda.resample_expand(st.particles[:, 4].contiguous(),
                                           t[1], N)
    assert torch.equal(single, expanded[:, 1])


def test_quantized_weights_follow_the_law(rng):
    """K5a's twin quantizes each firing filter's weights ``exp(lw - lse)``
    with ``quantize_weights_law`` of their float32 row sum, as the JAX
    step does (the sums' orders differ, so a weight may move by one), and
    the prefix is exact."""
    jst = _mixed_state(rng, (0, 3))
    st = _port(jst)
    fire = torch.tensor([True, False, False, True, False, False])
    slots = pb.wide_boundary(st.log_w, st.lse, fire, torch.zeros(B))
    assert slots.fids.tolist()[:2] == [0, 3]
    sel = slots.fids[:2].long()
    cum, inv_tot = pb.wide_prefix_plain(st.log_w[sel], st.lse[sel])
    w = np.exp(st.log_w.numpy() - st.lse.numpy()[:, None])
    for s, f in enumerate((0, 3)):
        wq = np.asarray(jpf.quantize_weights_law(
            jnp.asarray(w[f]), jnp.sum(jnp.asarray(w[f]))))
        got = torch.diff(cum[s], prepend=torch.zeros(1)).numpy()
        assert (np.abs(got - wq) <= 1).all() and (got != wq).mean() < 0.01
        assert cum[s, -1] == got.sum()
    assert inv_tot[0] == 1.0 / cum[0, -1]


@pytest.mark.parametrize("n", [1, 3, 1023, 1024, 1025, 10_000])
def test_row_total_is_the_kernels_order(n):
    """K5a's twin sums a row in the kernel's documented order: thread
    ``(j mod 4T) // 4`` takes lane j, each thread adds its lanes in
    sequence from 0, then a tree of halving adds over the T threads; a
    numpy float32 loop of that order gives the same bits."""
    g = np.random.default_rng(n)
    w = np.exp(g.normal(size=(2, n)) * 3.0).astype(np.float32)
    t = pb._BOUND_THREADS
    want = []
    for row in w:
        acc = np.zeros(t, np.float32)
        for base in range(0, n, 4 * t):
            for k in range(4):  # a thread's four lanes of the tile, in order
                lanes = base + 4 * np.arange(t) + k
                ok = lanes < n
                acc[ok] = acc[ok] + row[lanes[ok]]
        while acc.size > 1:
            acc = acc[:acc.size // 2] + acc[acc.size // 2:]
        want.append(acc[0])
    got = pb.wide_row_total_plain(torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))


def test_boundaries_match_jax_quantize_and_decode(rng):
    """K5a's twin against the JAX package's quantization (row sum by
    ``jnp.sum``) and ``slot_boundaries_from_wq`` on the same offsets: the
    two row sums' orders differ, so a weight, and the boundaries after
    it, may move by one; at most 1% of a filter's lanes differ (the
    allowance of the step tests, ``_assert_close``)."""
    jst = _mixed_state(rng, (0, 2, 5))
    st = _port(jst)
    fire = torch.tensor([True, False, True, False, False, True])
    offs = torch.rand(B, generator=torch.Generator().manual_seed(2))
    slots = pb.wide_boundary(st.log_w, st.lse, fire, offs)
    w = np.exp(st.log_w.numpy() - st.lse.numpy()[:, None])
    for s, f in enumerate((0, 2, 5)):
        wq = jpf.quantize_weights_law(jnp.asarray(w[f]),
                                      jnp.sum(jnp.asarray(w[f])))
        want = np.asarray(jrs.slot_boundaries_from_wq(
            wq[None], N, jnp.float32(offs[f])))[0]
        got = slots.t_hi[s].numpy()
        assert (got != want).mean() <= 0.01
        assert got[-1] == want[-1] == N


def test_bad_filter_resets_to_uniform(rng):
    """``bad & ~fire``: a filter with NaN normalizers does not fire and
    restarts at log weight 0 (the wide path's unnormalized uniform); the
    step matches the JAX package's."""
    jst = _mixed_state(rng, (4,), bad_ids=(2,))
    key = jax.random.key(5)
    jst2, jout = _jax_step(jst, key)
    offs, noise = _draws(key)
    st2, out = pb.pf_batch_wide_step(CFG, _port(jst), None, 1,
                                     noise_on=False, obs_noise=noise,
                                     offs=offs)
    assert out.bad.tolist() == [False, False, True, False, False, False]
    assert out.resampled.tolist() == [False] * 4 + [True, False]
    assert torch.isfinite(st2.log_w).all() and torch.isfinite(st2.lse).all()
    _assert_close(_port(jst2), jout, st2, out)


def test_rollout_matches_jax_steps(rng):
    """Four noise-free steps from the mixed state against the JAX step
    looped on the same draws: the firing pattern equal, particles and
    estimates within ``_assert_close``'s tolerances at the end."""
    jst = _mixed_state(rng, (0, 2, 5))
    state0 = _port(jst)
    keys = jax.random.split(jax.random.key(8), 4)
    draws = [_draws(k) for k in keys]
    fired = []
    for k in keys:
        jst, jout = _jax_step(jst, k)
        fired.append(np.asarray(jout.resampled))
    final, outs = pb.pf_batch_wide_rollout(
        CFG, None, B, 4, noise_on=False, device="cpu", state0=state0,
        offs=np.stack([d[0] for d in draws]),
        obs_noise=np.stack([d[1] for d in draws]))
    assert (outs.resampled.numpy() == np.stack(fired)).all()
    assert outs.resampled[0].tolist() == [True, False, True, False, False,
                                          True]
    # After three steps the carried normalizers differ by the two
    # packages' summation orders, and the ESS with them (rtol 1e-4).
    out = pb.PfBatchOut(*(f[-1] for f in outs))
    _assert_close(_port(jst), jout, final, out, ess_rtol=1e-4)


def _stats64(p_rows: torch.Tensor, lw: torch.Tensor):
    """Each filter's ``(lse, lse2, x_est)`` in float64 from ``(B, n)``
    log weights: a NaN poisons the sums, an all -inf filter sums to -inf,
    and the MAP is the highest index among the non-NaN maxima."""
    lw64 = lw.double().numpy()
    key = np.where(np.isnan(lw64), -np.inf, lw64)
    lse, lse2, est = [], [], []
    for f, (row, k) in enumerate(zip(lw64, key)):
        m = k.max()
        shift = m if np.isfinite(m) else 0.0
        e = np.exp(row - shift)
        with np.errstate(divide="ignore"):
            lse.append(m + np.log(e.sum()))
            lse2.append(2 * m + np.log((e * e).sum()))
        best = np.flatnonzero(k == m).max()
        est.append(p_rows[:, f, best].numpy())
    return np.array(lse), np.array(lse2), np.stack(est)


@pytest.mark.parametrize("case", ["tied maxima", "NaN log weight",
                                  "all -inf filter", "n = 10,001"])
def test_stats_twin_matches_float64(case):
    """K5b's twin writes each filter's ``lse``, ``lse2`` and MAP particle
    itself: they equal a float64 logsumexp (rtol 1e-6) and argmax of the
    log weights it returns.  Tied maxima go to the highest index, a NaN
    log weight never wins but makes that filter's sums NaN, an all -inf
    filter keeps ``lse = lse2 = -inf`` with no NaN, and a filter of
    10,001 particles (the kernel's ragged last pass) reduces as any."""
    b, n = (2, 10_001) if case == "n = 10,001" else (3, 64)
    g = torch.Generator().manual_seed(3)
    cfg = tpf.PfConfig(num_particles=n, weight_mode="log")
    particles = (torch.tensor(CFG.x0)[:, None, None]
                 + 0.4 * torch.randn((3, b, n), generator=g))
    log_w = 2.0 * torch.randn((b, n), generator=g)
    # 1e5 lifts a particle above any other's log-likelihood here.
    if case == "tied maxima":  # three equal poses and weights on top
        for j in (5, 40, 63):
            particles[:, 1, j] = particles[:, 1, 5]
            log_w[1, j] = 1e5
    elif case == "NaN log weight":
        log_w[1, 7] = float("nan")
        log_w[1, 9] = 1e5
    elif case == "all -inf filter":
        log_w[2] = float("-inf")
    z = torch.randn((b, N_LM, 2), generator=g)
    off = torch.zeros(b, dtype=torch.bool)
    p, lw, lse, lse2, x_est, _ = pb.wide_stats_rows_plain(
        cfg, 0, particles, log_w, z, off, off, noise_on=False)
    want_lse, want_lse2, want_est = _stats64(p, lw)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6)
    np.testing.assert_allclose(lse2.numpy(), want_lse2, rtol=1e-6)
    np.testing.assert_array_equal(x_est.numpy(), want_est)
    if case == "tied maxima":
        assert torch.equal(x_est[1], p[:, 1, 63])
    elif case == "NaN log weight":
        assert torch.isnan(lse[1]) and torch.isnan(lse2[1])
        assert torch.isfinite(lse[[0, 2]]).all()
        assert torch.equal(x_est[1], p[:, 1, 9])
    elif case == "all -inf filter":
        assert lse[2] == float("-inf") and lse2[2] == float("-inf")
        assert torch.equal(x_est[2], p[:, 2, n - 1])


def test_philox_rollout_tracks_truth():
    """The twins' own Philox noise, 4 filters x 5000 particles x 60 steps
    from ``pf_batch_wide_init`` (under torch's 32768-element grain, so
    every op stays on one thread beside the other test workers): the
    position RMSE over every filter and step lies in ``bench.py``'s band
    (0.02, 0.50) m; the CPU dispatch launches nothing and the rollout is
    reproducible."""
    cfg = tpf.PfConfig(num_particles=5000, weight_mode="log")
    counts = _build.launches.copy()
    final, outs = pb.pf_batch_wide_rollout(
        cfg, torch.Generator().manual_seed(5), 4, 60, device="cpu")
    assert _build.launches == counts
    e = outs.x_est[..., :2] - outs.x_true[:, None, :2]
    rmse = float(torch.sqrt((e ** 2).sum(-1).mean()))
    assert 0.02 < rmse < 0.50, rmse
    assert outs.resampled.any() and not outs.bad.any()
    again = pb.pf_batch_wide_rollout(
        cfg, torch.Generator().manual_seed(5), 4, 60, device="cpu")
    assert torch.equal(again[1].x_est, outs.x_est)


@pytest.mark.parametrize("r,tile", [(1, 256), (8, 1024)])
def test_state_converters_round_trip(rng, r, tile):
    """JAX wide states flat and packed (``sub_rows=8``, the rollout's
    default at ``tile_n=1024``) read into ``(3, B, n)`` without padding;
    written back they are the flat padded layout; the port's init is the
    JAX package's."""
    st = jpb.pf_batch_wide_init(JCFG, B, tile, sub_rows=r)
    p = rng.normal(size=st.particles.shape).astype(np.float32)
    lw = rng.normal(size=st.log_w.shape).astype(np.float32)
    jst = st._replace(particles=jnp.asarray(p), log_w=jnp.asarray(lw))
    flat_p = np.asarray(jpb.flat_batch_rows(jnp.asarray(p), B, r))
    np_ = flat_p.shape[1] // B
    port = _port(jst)
    np.testing.assert_array_equal(port.particles.numpy(),
                                  flat_p.reshape(3, B, np_)[:, :, :N])
    back = convert.pf_batch_wide_state_to_numpy(port, tile)
    assert back.particles.shape == (3, B * np_)
    assert np.isneginf(back.log_w.reshape(B, np_)[:, N:]).all()
    assert torch.equal(_port(back).log_w, port.log_w)
    init = pb.pf_batch_wide_init(CFG, B, device="cpu")
    jinit = _port(jpb.pf_batch_wide_init(JCFG, B, tile, sub_rows=r))
    for name in init._fields:
        np.testing.assert_allclose(getattr(init, name).numpy(),
                                   getattr(jinit, name).numpy(), rtol=1e-6,
                                   err_msg=name)


def test_seed_stride_is_the_jax_rollouts():
    """``max(7919, B * W)`` with W the JAX rollout's 1024-lane tiles
    (``pf_batch_pallas.py:1566``)."""
    assert pb.wide_seed_step(CFG, 1024) == 7919
    assert pb.wide_seed_step(CFG, 8192) == 8192
    assert pb.wide_seed_step(tpf.PfConfig(num_particles=10_000), 1024) \
        == 1024 * 10


@pytest.mark.parametrize("fn", [pb.pf_batch_wide_init,
                                pb.pf_batch_wide_rollout])
def test_device_is_required(fn):
    cfg = tpf.PfConfig(num_particles=8)
    with pytest.raises(TypeError, match="device"):
        fn(cfg, 2) if fn is pb.pf_batch_wide_init else fn(cfg, None, 2, 2)


def test_generator_must_lie_on_the_rollout_device():
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(ValueError, match="generator on cpu"):
        pb.pf_batch_wide_rollout(cfg, torch.Generator(), 2, 2,
                                 device="cuda")


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the kernel path is chip_smoke's")
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.pf_batch_wide_rollout(cfg, None, 2, 2, device="cuda")


def test_rejects_bad_arguments():
    b, n = 3, 8
    log_w = torch.zeros(b, n)
    ok = (log_w, torch.zeros(b, dtype=torch.int32),
          torch.zeros(b, dtype=torch.bool), torch.ones(b), torch.zeros(b))
    with pytest.raises(ValueError, match="lse dtype"):
        pb.wide_boundary(log_w, ok[1], *ok[2:4])
    with pytest.raises(ValueError, match="fire shape"):
        pb.wide_boundary(log_w, torch.zeros(b),
                         torch.zeros(b + 1, dtype=torch.bool), ok[3])
    cfg = tpf.PfConfig(num_particles=n, weight_mode="log")
    rows = (cfg, 0, torch.zeros(3, b, n), torch.zeros(b, n),
            torch.zeros(b, N_LM, 2), torch.zeros(b, dtype=torch.bool),
            torch.zeros(b, dtype=torch.bool))
    with pytest.raises(ValueError, match="together"):
        pb.wide_stats_rows(*rows, torch.zeros(b, dtype=torch.int32))
    with pytest.raises(ValueError, match="p_rows shape"):
        resample_cuda.resample_expand_seg(torch.zeros(3, b, n),
                                          torch.zeros(b, n - 1,
                                                      dtype=torch.int32),
                                          *ok[1:3])


def test_structs_mirror_cuda_source():
    """The ``ctypes`` mirrors of K5b's parameter and buffer structs list
    the fields of ``csrc/pf_wide.cu`` in its order, at its sizes."""
    src = (_build.CSRC_DIR / "pf_wide.cu").read_text()
    for name, mirror in (("WideParams", pb._WideParams),
                         ("WideBuffers", pb._WideBuffers)):
        body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        names = re.findall(r"(\w+)\s*(?:\[[^\]]*\])?\s*[,;]", body)
        assert names == [f[0] for f in mirror._fields_], name
    assert ctypes.sizeof(pb._WideParams) == 5 * 4 + 11 * 4 + 16 * 4
    assert {"inv_sx", "inv_sy", "ess_min"} <= {
        f[0] for f in pb._WideParams._fields_}
    assert ctypes.sizeof(pb._WideBuffers) == 16 * 8
    # A filter is one block, within the card's 1024 threads a block; K5a's
    # row-sum order is set by its threads a block.
    assert int(re.search(r"kStatsThreads = (\d+)", src).group(1)) <= 1024
    assert int(re.search(r"kBoundThreads = (\d+)", src).group(1)) \
        == pb._BOUND_THREADS <= 1024
    assert math.isclose(pb._WideParams(sx=0.3).sx, 0.3, rel_tol=1e-6)
