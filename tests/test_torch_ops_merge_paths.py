"""The merge resample's compressed path (K3c, K3d and their segmented
forms) against the JAX package on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them to
these plain twins there, bit for bit); here the twins are held to the
JAX package's ``compact_particles`` and ``merge_resample_rows(fused=...,
pass2=...)`` run in interpret mode, as ``tests/test_ops.py`` runs them
(its ``fused=False`` is a TPU schedule of the same pass 1, which the
port's one form must equal), and to the port's default paths.
Selection and values must be bit-identical: every comparison is exact,
except where XLA:CPU contracts the JAX boundary law into an FMA inside
``jit`` (then, lane for lane, the JAX side follows the contracted law, as
in ``test_torch_ops_resample``).
Weights are multiples of 2^-24 with a sum below 1, so both packages
quantize them to the same integers.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.ops.pf_batch_pallas as jpb
import tpuslam.ops.resample_pallas as jrs
from test_torch_ops_pf_wide import CFG as WIDE_CFG
from test_torch_ops_pf_wide import (JCFG, TILE, _assert_close, _draws,
                                    _mixed_state, _port)
from test_torch_ops_resample import (PROFILES, _contracted_boundaries,
                                     _exact_weights, _jax_hist, _profile)
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.ops import _build, pf_cuda, resample_cuda
from tpuslam_torch.ops import pf_batch_cuda as pb
from tpuslam_torch.ops.resample_cuda import (BLOCK, compact_particles,
                                             compact_particles_plain,
                                             compact_particles_seg,
                                             decode_indices,
                                             expand_compressed,
                                             expand_compressed_seg,
                                             expand_seg, merge_options,
                                             merge_resample_rows,
                                             merge_resample_rows_plain,
                                             resample_expand,
                                             resample_expand_seg,
                                             slot_boundaries)

N, N_PAD = 1000, 1024
SRC = (_build.CSRC_DIR / "resample.cu").read_text()
PATHS = [(True, "windowed"), (False, "windowed"), (True, "compressed"),
         (False, "compressed")]  # the JAX merge's (fused, pass2)
PASS2 = resample_cuda.PASS2
TPU_CAPS = ["t_in", "t_k", "t_out", "w_b", "w_b_small", "t_k_small"]


def _rows(rng, n_pad: int) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=(3, n_pad)).astype(np.float32))


def _stack_reference(p: np.ndarray, t: np.ndarray):
    """K3c's stack by loops in numpy: per block, the survivors' values
    and intervals in lane order, then the inert columns."""
    n_pad = t.shape[0]
    prev = np.concatenate([[0], t[:-1]])
    vals = np.zeros((3, n_pad), np.float32)
    iv = np.zeros((2, n_pad), np.int32)
    cnt = []
    for lo in range(0, n_pad, BLOCK):
        hi = min(lo + BLOCK, n_pad)
        js = [j for j in range(lo, hi) if t[j] > prev[j]]
        cnt.append(len(js))
        vals[:, lo:lo + len(js)] = p[:, js]
        iv[0, lo:lo + len(js)] = prev[js]
        iv[1, lo:lo + len(js)] = t[js]
        iv[:, lo + len(js):hi] = t[hi - 1]
    return vals, iv, np.asarray(cnt, np.int32)


@pytest.mark.parametrize("n,n_pad", [(N, N_PAD), (5000, 8192)])
@pytest.mark.parametrize("name", ["heavy", "near-uniform"])
def test_compact_matches_jax_compact_particles(rng, name, n, n_pad):
    """K3c's twin against the JAX ``compact_particles`` (one 1024-lane
    tile a block, ``t_k = 1024``) on the JAX ``boundary_decode``: the
    first ``cnt`` columns of every block, values (the bf16 split rows
    recombined ``hi + mid + lo`` in float32) and intervals, and the
    counts."""
    w = _profile(rng, name, n, n_pad)
    p = _rows(rng, n_pad)
    offs = np.float32(rng.uniform())
    t_row, tprev, f_row, g_row, cnt_j, _ = jrs.boundary_decode(
        jnp.asarray(w)[None], n, jnp.float32(offs), BLOCK, BLOCK)
    t = slot_boundaries(torch.from_numpy(w), n, float(offs))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_row)[0])
    tc = np.asarray(jrs.compact_particles(
        jnp.asarray(p.numpy()), t_row, tprev, f_row, g_row, BLOCK, BLOCK,
        interpret=True)).astype(np.float32)
    want = (tc[0::3] + tc[1::3]) + tc[2::3]  # x y yaw t_hi t_lo
    vals, iv, cnt = compact_particles_plain(p, t)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    for b, c in enumerate(cnt.tolist()):
        cols = slice(b * BLOCK, b * BLOCK + c)
        np.testing.assert_array_equal(vals[:, cols].numpy(), want[:3, cols])
        np.testing.assert_array_equal(iv[1, cols].numpy(), want[3, cols])
        np.testing.assert_array_equal(iv[0, cols].numpy(), want[4, cols])


@pytest.mark.parametrize("name,n,n_pad", PROFILES)
def test_compact_stack_and_compression(rng, name, n, n_pad):
    """The whole stack (inert columns too) equals a loop over the lanes;
    across a block edge a survivor's ``t_lo`` is the previous block's last
    boundary.  The stack's ``t_hi`` row is sorted and its first column
    above any slot is a survivor, so K3d's twin searches it with no
    compression and gives K3b's rows."""
    w = torch.from_numpy(_profile(rng, name, n, n_pad))
    p = _rows(rng, n_pad)
    t = slot_boundaries(w, n, 0.375)
    vals, iv, cnt = compact_particles(p, t)
    for got, want in zip((vals, iv, cnt), _stack_reference(p.numpy(),
                                                           t.numpy())):
        np.testing.assert_array_equal(got.numpy(), want)
    assert (iv[1, 1:] >= iv[1, :-1]).all()
    first = torch.searchsorted(iv[1], torch.arange(n, dtype=torch.int32),
                               right=True)
    assert (iv[0, first] < iv[1, first]).all()  # a survivor, not inert
    assert int(first.max()) <= n - 1
    assert torch.equal(expand_compressed(vals, iv, n),
                       resample_expand(p, t, n))


def test_block_edge_survivors(rng):
    """Survivors on the first lane of blocks 1 and 2 take their ``t_lo``
    from the last lane of the block before; a block's columns past its
    count are inert at its last boundary, and the expand over the stack
    equals K3b."""
    n = n_pad = 3 * BLOCK
    w = np.zeros(n_pad)
    w[[5, BLOCK, 2 * BLOCK, 2 * BLOCK + 7]] = [1.0, 2.0, 3.0, 2.0]
    w = torch.from_numpy((w / w.sum() * (1 - 2 ** -20)).astype(np.float32))
    p = _rows(rng, n_pad)
    t = slot_boundaries(w, n, 0.5)
    vals, iv, cnt = compact_particles(p, t)
    assert cnt.tolist() == [1, 1, 2]
    assert iv[:, BLOCK].tolist() == [int(t[BLOCK - 1]), int(t[BLOCK])]
    assert iv[:, 2 * BLOCK].tolist() == [int(t[2 * BLOCK - 1]),
                                         int(t[2 * BLOCK])]
    assert torch.equal(vals[:, BLOCK], p[:, BLOCK])
    assert (iv[:, BLOCK + 1:2 * BLOCK] == t[2 * BLOCK - 1]).all()
    cols = [0, BLOCK, 2 * BLOCK, 2 * BLOCK + 1]
    assert iv[0, cols].tolist() == [0, int(t[BLOCK - 1]),
                                    int(t[2 * BLOCK - 1]), int(t[2 * BLOCK])]
    assert iv[1, cols].tolist() == t[[5, BLOCK, 2 * BLOCK,
                                      2 * BLOCK + 7]].tolist()
    assert torch.equal(expand_compressed(vals, iv, n),
                       resample_expand(p, t, n))


@pytest.mark.parametrize("fused,pass2", PATHS)
@pytest.mark.parametrize("name,seed", [("heavy", 1000),
                                       ("near-uniform", 45)])
def test_merge_paths_match_jax_interpret_kernel(rng, name, seed, fused,
                                                pass2):
    """Each ``(fused, pass2)`` merge of the JAX package in interpret mode
    (caps ``t_in = t_k = t_out = 1024``, ``w_b = 3``) against the port's
    ``pass2`` merge, the comb offset from the same key.  The port equals its
    default path and the eager hist decode bit for bit; the JAX kernel
    equals the port or, lane for lane, the FMA-contracted law (with key
    45 the near-uniform profile has one such lane)."""
    w = _profile(rng, name, N, N_PAD)
    p = _rows(rng, N_PAD)
    key = jax.random.key(seed)
    got_j = np.asarray(jrs.merge_resample_rows(
        key, jnp.asarray(p.numpy()), jnp.asarray(w)[None], N,
        t_in=1024, t_k=1024, t_out=1024, w_b=3, interpret=True,
        fused=fused, pass2=pass2))
    offs = float(jax.random.uniform(key, dtype=jnp.float32))
    wt = torch.from_numpy(w)
    got = merge_resample_rows(p, wt, N, offs, device="cpu", pass2=pass2)
    assert torch.equal(got, merge_resample_rows(p, wt, N, offs,
                                                device="cpu"))
    want = np.zeros_like(got.numpy())
    want[:, :N] = p.numpy()[:, :N][:, _jax_hist(w, N, offs)]
    np.testing.assert_array_equal(got.numpy(), want)
    if not np.array_equal(got_j, got.numpy()):
        t_fma = _contracted_boundaries(w, N, offs)
        want_fma = np.zeros_like(want)
        want_fma[:, :N] = p.numpy()[:, :N][:, decode_indices(t_fma,
                                                             N).numpy()]
        np.testing.assert_array_equal(got_j, want_fma)


@pytest.mark.parametrize("name,n,n_pad", PROFILES)
def test_four_paths_bit_equal(rng, name, n, n_pad):
    """Both ``pass2`` paths, kernel wrappers and plain twins, give the
    same rows bit for bit on every profile."""
    w = torch.from_numpy(_profile(rng, name, n, n_pad))
    p = _rows(rng, n_pad)
    ref = merge_resample_rows(p, w, n, 0.625, device="cpu")
    for pass2 in PASS2:
        for fn in (merge_resample_rows, merge_resample_rows_plain):
            assert torch.equal(fn(p, w, n, 0.625, device="cpu",
                                  pass2=pass2), ref)


def test_segmented_forms_are_the_single_filter_forms(rng):
    """Slot s of the segmented K3c and K3d twins is the single-filter
    stack and rows of its filter; idle slots' counts are 0 and their rows
    0; the compressed pass B equals the windowed one."""
    b, n = 5, 2500
    p = torch.from_numpy(rng.normal(size=(3, b, n)).astype(np.float32))
    w = np.exp(rng.normal(size=(b, n)) * 4.0)
    fids = torch.tensor([3, 0, 4, 0, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, False])
    t = torch.zeros((b, n), dtype=torch.int32)
    for s, f in enumerate((3, 0, 4)):
        wf = torch.from_numpy(_exact_weights(w[f]))
        t[s] = slot_boundaries(wf, n, 0.2 * s)
    counts = _build.launches.copy()
    vals, iv, cnt = compact_particles_seg(p, t, fids, valid)
    out = expand_compressed_seg(vals, iv, valid)
    assert _build.launches == counts
    for s, f in enumerate((3, 0, 4)):
        single = compact_particles(p[:, f].contiguous(), t[s])
        assert torch.equal(vals[:, s], single[0])
        assert torch.equal(iv[:, s], single[1])
        assert torch.equal(cnt[s], single[2])
        assert torch.equal(out[:, s], resample_expand(p[:, f].contiguous(),
                                                      t[s], n))
    assert not cnt[3:].any() and not out[:, 3:].any()
    assert torch.equal(expand_seg(p, t, fids, valid, "compressed"),
                       resample_expand_seg(p, t, fids, valid))


@pytest.mark.parametrize("skew,seed", [((1, 4, 5), 11), ((0, 2, 3), 7)])
def test_wide_compressed_step_equals_windowed(rng, skew, seed):
    """``pf_batch_wide_step(pass2="compressed")`` equals the windowed step
    bit for bit: particles, log weights, normalizers, estimates."""
    jst = _mixed_state(rng, skew)
    offs, noise = _draws(jax.random.key(seed))
    kw = dict(noise_on=False, obs_noise=noise, offs=offs)
    st_w, out_w = pb.pf_batch_wide_step(WIDE_CFG, _port(jst), None, 1, **kw)
    st_c, out_c = pb.pf_batch_wide_step(WIDE_CFG, _port(jst), None, 1,
                                        pass2="compressed", **kw)
    assert out_c.resampled.sum() == 3
    for a, c in zip(st_w, st_c):
        assert torch.equal(a, c)
    assert torch.equal(out_w.x_est, out_c.x_est)


def test_wide_compressed_step_matches_jax_interpret(rng):
    """The port's compressed wide step against the JAX
    ``pf_batch_wide_step(pass2="compressed")`` in interpret mode (6 filters
    x 1000, tile 256, noise off), within ``_assert_close``'s
    tolerances."""
    jst = _mixed_state(rng, (1, 4, 5))
    key = jax.random.key(11)
    jst2, jout = jpb.pf_batch_wide_step(JCFG, jst, key, 1, tile_n=TILE,
                                        noise_on=False, interpret=True,
                                        pass2="compressed")
    offs, noise = _draws(key)
    st2, out = pb.pf_batch_wide_step(WIDE_CFG, _port(jst), None, 1,
                                     noise_on=False, obs_noise=noise,
                                     offs=offs, pass2="compressed")
    assert out.resampled.tolist() == [False, True, False, False, True, True]
    _assert_close(_port(jst2), jout, st2, out)


def test_wide_rollout_compressed_equals_default():
    """A short Philox wide rollout gives the same outputs with either pass
    B, and the CPU dispatch launches nothing."""
    cfg = tpf.PfConfig(num_particles=3000, weight_mode="log",
                       ess_threshold_frac=0.5)
    runs = [pb.pf_batch_wide_rollout(cfg, torch.Generator().manual_seed(2),
                                      3, 6, device="cpu", pass2=pass2)
            for pass2 in resample_cuda.PASS2]
    assert runs[0][1].resampled.any()
    for a, c in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, c)
    assert torch.equal(runs[0][1].x_est, runs[1][1].x_est)


@pytest.mark.parametrize("plain", [False, True])
def test_rollout_merge_caps_kw_equals_default(plain):
    """A 3-step single-filter rollout that resamples every step (the gate
    forced) gives the same state and estimates with
    ``merge_caps_kw=(("pass2", "compressed"),)``, with no host sync (the
    merge gates on the device)."""
    cfg = tpf.PfConfig(num_particles=1000, weight_mode="log",
                       resample_method="merge", ess_threshold_frac=2.0)
    rollout = (pf_cuda.pf_fused_rollout_plain if plain
               else pf_cuda.pf_fused_rollout)
    kw = (("pass2", "compressed"),)
    syncs = pf_cuda.sync_count
    a = rollout(cfg, torch.Generator().manual_seed(4), 3, device="cpu")
    b = rollout(cfg, torch.Generator().manual_seed(4), 3, device="cpu",
                merge_caps_kw=kw)
    assert pf_cuda.sync_count == syncs
    assert torch.equal(a[0].particles, b[0].particles)
    assert torch.equal(a[1][1], b[1][1])


def test_step_stats_forwards_merge_caps_kw(rng):
    """``pf_fused_step_stats`` forwards the pairs to the merge: a firing
    step is the same with either ``pass2`` (beside the JAX default
    ``("fused", True)``), and ``("fused", False)`` raises."""
    cfg = tpf.PfConfig(num_particles=1000, weight_mode="log",
                       resample_method="merge", ess_threshold_frac=2.0)
    lw = torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 3.0)
    fs = pf_cuda.pf_fused_init(cfg, device="cpu")._replace(
        particles=_rows(rng, 1000), log_w=lw, lse=torch.logsumexp(lw, 0),
        lse2=torch.logsumexp(2 * lw, 0))
    step = dict(offs=0.3, obs_noise=torch.zeros(5, 2))
    ref, _ = pf_cuda.pf_fused_step_stats(cfg, fs, None, 9, **step)
    for fused, pass2 in PATHS:
        kw = (("fused", fused), ("pass2", pass2))
        if not fused:
            with pytest.raises(ValueError, match="'fused', False"):
                pf_cuda.pf_fused_step_stats(cfg, fs, None, 9,
                                            merge_caps_kw=kw, **step)
            continue
        got, _ = pf_cuda.pf_fused_step_stats(cfg, fs, None, 9,
                                             merge_caps_kw=kw, **step)
        assert torch.equal(got.particles, ref.particles)


def test_merge_options():
    """``pass2`` is the one setting; ``("fused", True)`` is dropped, and
    ``fused`` of any other value (a string or number too) raises."""
    assert merge_options() == {}
    assert merge_options((("fused", True), ("pass2", "compressed"))) == {
        "pass2": "compressed"}
    for value in (False, "False", 0.0, 1):
        with pytest.raises(ValueError, match="'fused'.*no counterpart"):
            merge_options((("fused", value), ("pass2", "compressed")))


@pytest.mark.parametrize("cap", TPU_CAPS)
def test_tpu_caps_have_no_counterpart(cap):
    """A TPU cap in ``merge_caps_kw`` raises, naming it, in the options,
    the step and the rollout."""
    with pytest.raises(ValueError, match=f"'{cap}'.*no counterpart"):
        merge_options(((cap, 512),))
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log",
                       resample_method="merge")
    with pytest.raises(ValueError, match=f"'{cap}'"):
        pf_cuda.pf_fused_rollout(cfg, None, 1, device="cpu",
                                 merge_caps_kw=(("pass2", "compressed"),
                                                (cap, 128)))


def test_unknown_pass2_raises():
    p, w = torch.zeros(3, 8), torch.full((8,), 0.125)
    with pytest.raises(ValueError, match="pass2"):
        merge_resample_rows(p, w, 8, 0.5, device="cpu", pass2="skip")
    with pytest.raises(ValueError, match="pass2"):
        merge_resample_rows_plain(p, w, 8, 0.5, device="cpu", pass2="skip")
    with pytest.raises(ValueError, match="pass2"):
        merge_options((("pass2", "wide"),))
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(ValueError, match="pass2"):
        pb.pf_batch_wide_rollout(cfg, None, 2, 2, device="cpu",
                                 pass2="windows")
    st = pb.pf_batch_wide_init(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="pass2"):
        pb.pf_batch_wide_step(cfg, st, None, 1, pass2="compress")


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the kernel path is chip_smoke's")
    p, w = torch.zeros(3, 8), torch.full((8,), 0.125)
    for pass2 in PASS2:
        with pytest.raises(RuntimeError, match="CUDA"):
            merge_resample_rows(p, w, 8, 0.5, device="cuda", pass2=pass2)
    cfg = tpf.PfConfig(num_particles=8, weight_mode="log")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.pf_batch_wide_rollout(cfg, None, 2, 2, device="cuda",
                                 pass2="compressed")


def test_rejects_bad_arguments():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="iv shape"):
        expand_compressed_seg(torch.zeros(3, 2, 8),
                              torch.zeros(2, 2, 7, dtype=torch.int32),
                              torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="valid dtype"):
        expand_compressed_seg(torch.zeros(3, 2, 8),
                              torch.zeros(2, 2, 8, dtype=torch.int32),
                              torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="p_rows shape"):
        compact_particles_seg(torch.zeros(3, 2, 8),
                              torch.zeros(2, 7, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32),
                              torch.ones(2, dtype=torch.bool))
    # A stack whose intervals do not cover the slots is refused.
    vals, iv, _ = compact_particles(torch.zeros(3, 8), t + 8)
    with pytest.raises(ValueError, match="partition"):
        expand_compressed(vals, iv.flip(-1), 8)


def test_kernel_source_interface():
    """The new launches are C entry points of ``csrc/resample.cu``,
    declared for ``ctypes``: K3c one kernel (the single filter one slot of
    it), K3d one kernel a design (a range of output slots for one slot, a
    window of stack blocks for more); the stack's block is
    :data:`BLOCK`."""
    build = (_build.CSRC_DIR.parent / "ops" / "_build.py").read_text()
    for name in ("tpuslam_resample_compact",
                 "tpuslam_resample_expand_compressed"):
        assert re.search(rf'extern "C" int {name}\(', SRC), name
        assert f'"{name}"' in build, name
    for kernel in ("compact_kernel", "compressed_range_kernel",
                   "compressed_window_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\(\w+\)\n"
                         rf"{kernel}\(", SRC), kernel
    assert re.search(r"kScanBlock = (\d+)", SRC).group(1) == str(BLOCK)


# K3d's lookups (csrc/resample.cu), repeated in torch: which live stack
# columns each block stages, and each output slot's survivor among them.
RANGE_SLOTS = int(re.search(r"kRangeSlots = (\d+)", SRC).group(1))
STACK_WINDOW = int(re.search(r"kStackWindow = (\d+)", SRC).group(1))
N_STAGE, N_PAD_STAGE = 10_000, 10_240


def _live(cnt, k0: int, k1: int, lo: int = 0, hi: int = 1 << 30):
    """The live columns of stack blocks k0 .. k1 (block k's first
    ``cnt[k]``) from ``lo`` to ``hi``, in order: what a block stages."""
    return torch.tensor([c for k in range(k0, k1 + 1)
                         for c in range(k * BLOCK, k * BLOCK + int(cnt[k]))
                         if lo <= c <= hi], dtype=torch.int64)


def _expand_staged(iv, cols, a: int, e: int) -> torch.Tensor:
    """``expand_staged``: the column of each slot of ``[a, e)``, the first
    staged one whose ``t_hi`` is above it; raises where its interval does
    not hold the slot (the kernel's device assert)."""
    i = torch.arange(a, e, dtype=torch.int32)
    j = torch.searchsorted(iv[1][cols], i, right=True)
    if bool((j >= len(cols)).any()) or bool((iv[0][cols[j]] > i).any()):
        raise ValueError("the survivor stack does not partition the output "
                         "slots")
    return cols[j]


def _range_sources(iv, cnt, n: int) -> torch.Tensor:
    """``compressed_range_kernel``'s slot sources, block by block: the
    survivors of a range's first and last slot by a search of the
    ``t_hi`` row, the live columns between staged (never more than the
    range's slots)."""
    hi = iv[1][:n].contiguous()
    out = []
    for i0 in range(0, n, RANGE_SLOTS):
        i1 = min(n, i0 + RANGE_SLOTS)
        ca, cb = (int(torch.searchsorted(
            hi, torch.tensor([v], dtype=torch.int32), right=True))
            for v in (i0, i1 - 1))
        cols = _live(cnt, ca // BLOCK, cb // BLOCK, ca, cb)
        assert len(cols) <= RANGE_SLOTS
        out.append(_expand_staged(iv, cols, i0, i1))
    return torch.cat(out)


def _window_sources(iv, cnt, n: int) -> torch.Tensor:
    """``compressed_window_kernel``'s slot sources, window by window: the
    output slots ``[t_run(k0 - 1), t_run(k1))`` from two loads, the
    window's live columns staged."""
    hi = iv[1]
    out = []
    for k0 in range(0, len(cnt), STACK_WINDOW):
        k1 = min(len(cnt), k0 + STACK_WINDOW) - 1
        a = 0 if k0 == 0 else int(hi[k0 * BLOCK - 1])
        e = int(hi[min(n, (k1 + 1) * BLOCK) - 1])
        if a < e:
            cols = _live(cnt, k0, k1)
            assert len(cols) <= STACK_WINDOW * BLOCK
            out.append(_expand_staged(iv, cols, a, e))
    return torch.cat(out)


def _far_pair(n_pad: int) -> np.ndarray:
    """Two survivors eight stack blocks apart: the range that holds the
    edge between their slots spans seven empty blocks."""
    w = np.zeros(n_pad)
    w[[5, 8 * BLOCK + 9]] = [3.0, 5.0]
    return _exact_weights(w)


@pytest.mark.parametrize("name", ["heavy", "near-uniform", "single",
                                  "one-block-400", "far-pair"])
def test_k3d_lookups_find_each_slots_survivor(rng, name):
    """Both K3d designs' lookups over the stack's ``t_hi`` row and counts
    give every output slot the survivor a search of the whole row gives,
    staging at most their capacity; the ranges cover ``[0, n)`` with
    padding lanes past it, the windows (segmented rows: no padding) the
    whole row."""
    for n, n_pad in ((N_STAGE, N_PAD_STAGE), (N_PAD_STAGE, N_PAD_STAGE)):
        w = (_far_pair(n_pad) if name == "far-pair"
             else _profile(rng, name, n, n_pad))
        t = slot_boundaries(torch.from_numpy(w), n, 0.4375)
        _, iv, cnt = compact_particles_plain(_rows(rng, n_pad), t)
        want = torch.searchsorted(iv[1], torch.arange(n, dtype=torch.int32),
                                  right=True)
        assert torch.equal(_range_sources(iv, cnt, n), want)
        if n == n_pad:
            assert torch.equal(_window_sources(iv, cnt, n), want)


def test_k3d_lookups_raise_on_a_broken_partition(rng):
    """A survivor whose ``t_lo`` lies past its first slot stops both
    lookups, as the kernels' device assert does, and the plain twins."""
    n = n_pad = N_PAD_STAGE
    w = torch.from_numpy(_profile(rng, "near-uniform", n, n_pad))
    p = _rows(rng, n_pad)
    vals, iv, cnt = compact_particles_plain(p, slot_boundaries(w, n, 0.5))
    col = 3 * BLOCK + 7
    assert int(iv[0, col]) < int(iv[1, col])  # a survivor
    iv[0, col] += 1
    for lookup in (_range_sources, _window_sources):
        with pytest.raises(ValueError, match="partition"):
            lookup(iv, cnt, n)
    with pytest.raises(ValueError, match="partition"):
        expand_compressed(vals, iv, n)
    with pytest.raises(ValueError, match="partition"):
        expand_compressed_seg(vals[:, None], iv[:, None],
                              torch.ones(1, dtype=torch.bool))


def test_k3d_keeps_its_partition_check():
    """The K3d kernels assert each survivor's interval on the device, and
    no build flag compiles the assert out."""
    body = SRC[SRC.index("expand_staged("):]
    assert "assert(j < m && s_lo[j] <= i);" in body
    assert not any("NDEBUG" in flag for flag in _build.NVCC_FLAGS)
