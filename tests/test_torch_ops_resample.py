"""The merge resample's plain path against the JAX package on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them to
these plain twins there, bit for bit); here the plain twins are held to
the JAX package's ``hist`` decode and to its Pallas merge kernel run in
interpret mode, as ``tests/test_ops.py`` runs it.  Selection and values
must be bit-identical: every comparison is exact.

Weights are built as integer multiples of ``2^-24`` with a sum below 1,
so every summation order gives the same float32 total and the quantized
integers cannot differ between the two packages.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.filters.pf as jpf
import tpuslam.ops.resample_pallas as jrs
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.ops import _build, resample_cuda
from tpuslam_torch.ops.resample_cuda import (BLOCK, decode_indices,
                                             merge_resample_rows,
                                             merge_resample_rows_plain,
                                             quantize_weights,
                                             resample_boundary,
                                             resample_expand,
                                             slot_boundaries,
                                             slot_boundaries_from_wq)


def _exact_weights(w: np.ndarray) -> np.ndarray:
    """``w`` (any non-negative profile) as multiples of 2^-24 summing to
    below 1, so float32 sums are exact in every order."""
    k = np.floor(w / w.sum() * (2 ** 24 - len(w) - 1))
    return (k / 2 ** 24).astype(np.float32)


def _profile(rng, name: str, n: int, n_pad: int) -> np.ndarray:
    """Weight rows of ``n_pad`` lanes, the last ``n_pad - n`` zero."""
    w = np.zeros(n_pad)
    if name == "heavy":  # degenerate weights, the gate-firing regime
        lw = rng.normal(size=n) * 8.0
        w[:n] = np.exp(lw - lw.max())
    elif name == "near-uniform":  # dense survivors
        w[:n] = np.exp(rng.normal(size=n) * 0.1)
    elif name == "uniform":
        w[:n] = 1.0
    elif name == "single":
        w[min(377, n - 1)] = 1.0
    elif name == "one-block-400":  # 400 survivors in block 0, 128 in others
        w[:400] = 1.0
        for j in range(1, n // 2048):
            w[j * 2048:j * 2048 + 128] = 1.0
    w = _exact_weights(w)
    assert float(np.float32(w.sum(dtype=np.float32))) < 1.0
    return w


# The profiles of tests/test_ops.py's merge tests, then a single survivor,
# uniform weights and 400 survivors in one block; shapes are shared where
# possible, since each new shape costs the JAX side fresh compiles.
PROFILES = [("heavy", 1000, 1024), ("near-uniform", 900, 1024),
            ("heavy", 5000, 8192), ("single", 1000, 1024),
            ("uniform", 1000, 1024), ("one-block-400", 5000, 8192)]


def _jax_hist(w: np.ndarray, n: int, offs: float) -> np.ndarray:
    return np.asarray(jrs.decode_indices(
        jrs.slot_boundaries(jnp.asarray(w)[None], n, jnp.float32(offs)),
        n))


@pytest.mark.parametrize("name,n,n_pad", PROFILES)
def test_plain_selection_matches_jax_hist_decode(rng, name, n, n_pad):
    """Boundaries, decode and the resampled rows equal the JAX package's
    hist decode exactly, including the ``resample_indices`` form."""
    w = _profile(rng, name, n, n_pad)
    p = rng.normal(size=(3, n_pad)).astype(np.float32)
    offs = float(np.float32(rng.uniform()))
    t_j = np.asarray(jrs.slot_boundaries(jnp.asarray(w)[None], n,
                                         jnp.float32(offs)))[0]
    t_t = slot_boundaries(torch.from_numpy(w), n, offs)
    np.testing.assert_array_equal(t_t.numpy(), t_j)
    idx_j = _jax_hist(w, n, offs)
    np.testing.assert_array_equal(decode_indices(t_t, n).numpy(), idx_j)
    np.testing.assert_array_equal(
        tpf.resample_indices_from_offs(offs, torch.from_numpy(w[:n]),
                                       "hist").numpy(),
        np.asarray(jpf.resample_indices_from_offs(
            jnp.float32(offs), jnp.asarray(w[:n]), "hist")))
    out = merge_resample_rows_plain(torch.from_numpy(p), torch.from_numpy(w),
                                    n, offs, device="cpu")
    want = np.zeros_like(p)
    want[:, :n] = p[:, :n][:, idx_j]
    np.testing.assert_array_equal(out.numpy(), want)


def test_quantize_and_from_wq_match_jax(rng):
    n, n_pad, t_in = 5000, 8192, BLOCK
    w = _profile(rng, "heavy", n, n_pad)
    wq_j, base_j, tot_j = jrs.quantize_weights(jnp.asarray(w)[None], n,
                                               t_in)
    wq, base, tot = quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j)[0])
    np.testing.assert_array_equal(base.numpy(), np.asarray(base_j))
    assert float(tot) == float(tot_j)
    t_j = jrs.slot_boundaries_from_wq(wq_j, n, jnp.float32(0.25))
    np.testing.assert_array_equal(
        slot_boundaries_from_wq(wq, n, 0.25).numpy(), np.asarray(t_j)[0])
    # The kernels' block prefix plus base is the global cumsum.
    cum = torch.cumsum(wq, dim=0)
    blocks = torch.nn.functional.pad(wq, (0, -n_pad % t_in)).view(-1, t_in)
    assert torch.equal((torch.cumsum(blocks, 1) + base[:, None])
                       .flatten()[:n_pad], cum)


def _contracted_boundaries(w: np.ndarray, n: int, offs: float):
    """The boundary law as XLA:CPU compiles it inside ``jit``: ``n * y -
    offs`` contracted into one FMA (``y = cum * inv_tot`` rounded), so
    the product is not rounded before the subtract.  Emulated exactly in
    float64 (the 48-bit product and the difference fit in 53 bits) with
    one rounding to float32."""
    wq, _, q_tot = quantize_weights(torch.from_numpy(w))
    inv = np.float32(1.0) / np.float32(q_tot)
    y = (np.cumsum(wq.numpy(), dtype=np.float64).astype(np.float32) * inv)
    fma = (np.float64(n) * y.astype(np.float64) - np.float64(offs))
    t = np.clip(np.ceil(fma.astype(np.float32)), 0, n).astype(np.int32)
    t[n - 1:] = n
    return torch.from_numpy(t)


@pytest.mark.parametrize("name,seed", [("heavy", 1000),
                                       ("near-uniform", 45)])
def test_merge_matches_jax_interpret_kernel(rng, name, seed):
    """The port's merge (plain on the CPU) against the JAX Pallas merge
    kernel in interpret mode, the comb offset drawn from the same key.

    Inside ``jit`` XLA:CPU contracts the boundary law into an FMA; the
    eager hist decode, the port and its kernel (``__fmul_rn`` /
    ``__fsub_rn``) do not.  Where the two roundings put a boundary on
    different sides of an integer, the JAX merge follows the contracted
    law (with key 45 the near-uniform profile has one such lane, the
    boundary of particle 749).
    So the port must equal the uncontracted law bit for bit, and the JAX
    kernel must equal the port or, lane for lane, the contracted law.
    """
    n, n_pad = 1000, 1024
    w = _profile(rng, name, n, n_pad)
    p = rng.normal(size=(3, n_pad)).astype(np.float32)
    key = jax.random.key(seed)
    got_j = np.asarray(jrs.merge_resample_rows(
        key, jnp.asarray(p), jnp.asarray(w)[None], n, interpret=True))
    offs = float(jax.random.uniform(key, dtype=jnp.float32))
    got = merge_resample_rows(torch.from_numpy(p), torch.from_numpy(w), n,
                              offs, device="cpu").numpy()
    want = np.zeros_like(p)
    want[:, :n] = p[:, :n][:, _jax_hist(w, n, offs)]
    np.testing.assert_array_equal(got, want)
    if not np.array_equal(got_j, got):
        t_fma = _contracted_boundaries(w, n, offs)
        want_fma = np.zeros_like(p)
        want_fma[:, :n] = p[:, :n][:, decode_indices(t_fma, n).numpy()]
        np.testing.assert_array_equal(got_j, want_fma)


def test_every_slot_covered_once(rng):
    """The boundary partition: each output slot has exactly one source,
    the sources ascend, and single-survivor weights copy that particle."""
    n = 4096
    for name in ("heavy", "near-uniform", "single"):
        w = torch.from_numpy(_profile(rng, name, n, n))
        t = slot_boundaries(w, n, 0.5)
        assert bool((t[1:] >= t[:-1]).all()) and int(t[-1]) == n
        counts = torch.diff(t, prepend=t.new_zeros(1))
        idx = decode_indices(t, n)
        assert torch.equal(torch.bincount(idx, minlength=n),
                           counts.to(torch.int64))
    p = torch.arange(3 * n, dtype=torch.float32).view(3, n)
    out = merge_resample_rows(p, w, n, 0.5, device="cpu")
    assert torch.equal(out, p[:, 377:378].expand(3, n))


def test_generator_offset_and_kernel_wrappers_on_cpu(rng):
    """A generator draws the offset; the kernel wrappers' CPU path is the
    plain twin and counts no launch."""
    n = 1000
    w = torch.from_numpy(_profile(rng, "heavy", n, n))
    p = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    before = _build.launches.copy()
    g1 = torch.Generator().manual_seed(5)
    offs = torch.rand(1, generator=torch.Generator().manual_seed(5))
    a = merge_resample_rows(p, w, n, g1, device="cpu")
    b = merge_resample_rows_plain(p, w, n, offs, device="cpu")
    assert torch.equal(a, b)
    t = resample_boundary(w, n, offs)
    assert torch.equal(resample_expand(p, t, n), a)
    assert _build.launches == before


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the kernel path is chip_smoke's")
    p, w = torch.zeros(3, 8), torch.full((8,), 0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        merge_resample_rows(p, w, 8, 0.5, device="cuda")


@pytest.mark.parametrize("fn", [merge_resample_rows,
                                merge_resample_rows_plain])
def test_device_is_required(fn):
    with pytest.raises(TypeError, match="device"):
        fn(torch.zeros(3, 8), torch.full((8,), 0.125), 8, 0.5)


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(2, 8), torch.zeros(8), 8), "p_rows shape"),
    ((torch.zeros(3, 8), torch.zeros(7), 8), "w_row shape"),
    ((torch.zeros(3, 8), torch.zeros(8, dtype=torch.float64), 8), "dtype"),
    ((torch.zeros(3, 8), torch.zeros(8), 9), "n=9"),
    ((torch.zeros(3, 8), torch.zeros(8), 0), "n=0"),
])
def test_rejects_bad_arguments(args, match):
    with pytest.raises(ValueError, match=match):
        merge_resample_rows(*args, 0.5, device="cpu")


def test_kernel_source_interface():
    """The launches' C signatures are declared for ctypes, and the
    boundary law is written without FMA contraction."""
    src = (_build.CSRC_DIR / "resample.cu").read_text()
    for name in ("tpuslam_resample_boundary", "tpuslam_resample_expand"):
        assert re.search(rf'extern "C" int {name}\(', src), name
    assert "__fmul_rn" in src and "__fsub_rn" in src
    assert re.search(r"kScanBlock = (\d+)", src).group(1) == str(
        resample_cuda.BLOCK)
