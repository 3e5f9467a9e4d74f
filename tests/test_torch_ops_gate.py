"""The single filter's merge on its device gate, on the CPU.

The fused rollout's merge path takes no host decision: K3a computes the
ESS gate from the carried normalizers, writes it on the device, and it,
pass 2 (K3b, or K3c and K3d) and the step kernel K2b read it there
(``csrc/resample.cu``, ``csrc/pf_step.cu``).  The kernels run only on a
card, where ``chip_smoke.py`` holds them to these plain twins bit for
bit; here the twins are held to the host-gated forms they replace:

* the gated rollout to the host-gated rollout of ``resample_method=
  "hist"`` (the parent's merge selection, the same as ``hist``'s bit for
  bit), with the gate always on, never on and mixed, for both ``pass2``
  forms;
* K3a's twin, in both forms (log weights with their normalizer, or the
  weights given), to ``quantize_weights`` and the boundary law where the
  totals agree, and its fixed-order total to a float64 sum;
* the gate to the host's expression, and K2b's device flags to its host
  flag.

Exact equality throughout, except the float64 total (relative 1e-6).
Tensors stay under torch's 32,768-element grain.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from test_torch_ops_resample import PROFILES, _profile
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.ops import _build, pf_cuda
from tpuslam_torch.ops import resample_cuda as rs

N = 2000  # (3, N) rows: a ragged last tile of K3a's 1024 lanes
STEPS = 6


def _cfg(method: str, frac: float, n: int = N):
    return tpf.PfConfig(num_particles=n, weight_mode="log",
                        resample_method=method, ess_threshold_frac=frac)


def _rollout(cfg, pass2: str, gates: list | None = None):
    kw = (("pass2", pass2),) if cfg.resample_method == "merge" else ()
    return pf_cuda.pf_fused_rollout(cfg, torch.Generator().manual_seed(7),
                                    STEPS, device="cpu", merge_caps_kw=kw,
                                    gates=gates)


@pytest.mark.parametrize("pass2", rs.PASS2)
@pytest.mark.parametrize("frac,fires", [(2.0, "always"), (0.0, "never"),
                                        (0.5, "mixed")])
def test_gated_rollout_equals_host_gated(frac, fires, pass2):
    """Six Philox steps from ``pf_init``: the device-gated merge rollout
    equals the host-gated ``hist`` rollout bit for bit (final particles,
    log weights, normalizers and every estimate), with no host sync where
    the other makes one a step."""
    before = pf_cuda.sync_count
    gates = []
    gated = _rollout(_cfg("merge", frac), pass2, gates)
    assert pf_cuda.sync_count == before
    host = _rollout(_cfg("hist", frac), pass2)
    assert pf_cuda.sync_count == before + STEPS
    (g_state, (g_x, g_est)), (h_state, (h_x, h_est)) = gated, host
    for a, b in zip(g_state, h_state):
        assert torch.equal(a, b)
    assert torch.equal(g_x, h_x) and torch.equal(g_est, h_est)
    fired = int(torch.stack(gates)[:, 0].sum())
    assert {"always": fired == STEPS, "never": fired == 0,
            "mixed": 0 < fired < STEPS}[fires], fired


def test_search_syncs_once_a_step():
    """The default method keeps the host's gate: one sync a step, and no
    device gate."""
    before = pf_cuda.sync_count
    gates = []
    _rollout(_cfg("search", 0.5), "windowed", gates)
    assert pf_cuda.sync_count == before + STEPS
    assert gates == [None] * STEPS


@pytest.mark.parametrize("name,n,n_pad", PROFILES)
def test_boundary_twin_given_weights_is_the_quantized_law(rng, name, n,
                                                          n_pad):
    """K3a's twin on given weights equals ``quantize_weights`` and the law
    (``slot_boundaries``) where the totals agree, as they do for these
    weights (multiples of 2^-24 summing below 1), ragged ``n`` and
    ``n_pad > n`` included."""
    w = torch.from_numpy(_profile(rng, name, n, n_pad))
    assert float(rs.boundary_total_plain(w)) == float(w.sum())
    offs = float(np.float32(rng.uniform()))
    t = rs.resample_boundary_plain(w, n, offs)
    assert t.shape == (n_pad,) and t.dtype == torch.int32
    assert torch.equal(t, rs.slot_boundaries(w, n, offs))
    assert torch.equal(rs.resample_boundary(w, n, offs), t)


@pytest.mark.parametrize("n,n_pad", [(1000, 1024), (2049, 2049),
                                     (5003, 8192)])
def test_boundary_twin_log_form_is_the_weights_form(rng, n, n_pad):
    """The log form decodes ``exp(lw - lse)`` (lanes from ``n`` on
    ignored) exactly as the weights form decodes those weights."""
    lw = torch.from_numpy((rng.normal(size=n_pad) * 3.0).astype(np.float32))
    lse = torch.logsumexp(lw[:n], 0)
    offs = float(np.float32(rng.uniform()))
    w = torch.exp(lw - lse)
    w[n:] = 0.0
    t = rs.resample_boundary_plain(lw, n, offs, lse=lse)
    assert torch.equal(t, rs.resample_boundary_plain(w, n, offs))
    assert bool((t[1:] >= t[:-1]).all()) and bool((t[n - 1:] == n).all())


@pytest.mark.parametrize("n", [1, 1000, 4096, 30001])
def test_fixed_order_total_near_float64(rng, n):
    """The twin's fixed-order float32 total is within 1e-6 relative of the
    float64 sum of the same weights."""
    w = np.exp(rng.normal(size=n) * 2.0).astype(np.float32)
    got = float(rs.boundary_total_plain(torch.from_numpy(w)))
    want = float(w.astype(np.float64).sum())
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("lse,lse2", [(0.0, -3.0), (0.0, -9.5),
                                      (float("nan"), 0.0),
                                      (0.0, float("inf")),
                                      (float("-inf"), float("-inf"))])
def test_gate_is_the_host_expression(lse, lse2):
    """``[fire, bad | fire]`` equals the host gate's expression on the
    same normalizers; the threshold rounds to float32 as torch rounds the
    scalar."""
    n = 10_000
    for frac in (0.0, 0.5, 2.0, 1 / 3):
        cfg = _cfg("merge", frac, n)
        a, b = torch.tensor(lse), torch.tensor(lse2)
        bad, ess = pf_cuda._ess(cfg, a, b)
        fire = ess < n * frac
        gate = rs.ess_gate_plain(a, b, n, pf_cuda.ess_min(cfg))
        assert gate.dtype == torch.bool and gate.shape == (2,)
        assert gate.tolist() == [bool(fire), bool(bad | fire)]
    assert pf_cuda.ess_min(_cfg("merge", 1 / 3, n)) == ctypes.c_float(
        n / 3).value


def test_gate_at_its_threshold():
    """An ESS equal to the float32 threshold does not fire; one a float32
    step below it does (normalizers found near ``-log(threshold)``, where
    a step of ``lse2`` moves the ESS by less than a step of its own)."""
    n, frac = 3, 0.5
    thr = np.float32(n * frac)
    below = np.nextafter(thr, np.float32(0))
    lse2 = torch.tensor(-np.log(np.float64(thr)), dtype=torch.float32)
    steps = torch.arange(-64, 65, dtype=torch.float32) * float(
        np.spacing(np.float32(lse2)))
    cands = lse2 + steps
    ess = torch.exp(-cands)  # lse = 0
    lse = torch.tensor(0.0)
    ess_min = pf_cuda.ess_min(_cfg("merge", frac, n))
    assert ess_min == float(thr)
    for value, fire in ((thr, False), (below, True)):
        hit = cands[ess == float(value)]
        assert hit.numel() >= 1, value
        gate = rs.ess_gate_plain(lse, hit[0], n, ess_min)
        assert gate.tolist() == [fire, fire]


@pytest.mark.parametrize("pass2", rs.PASS2)
def test_gated_merge_fires_as_the_weights_form(rng, pass2):
    """Where the gate fires, the gated merge (log weights) gives the rows
    of ``merge_resample_rows`` on ``exp(lw - lse)``, padding lanes zero;
    with ``n_pad > n`` too."""
    n, n_pad = 3000, 3072
    p = torch.from_numpy(rng.normal(size=(3, n_pad)).astype(np.float32))
    lw = torch.from_numpy((rng.normal(size=n_pad) * 3.0).astype(np.float32))
    lse, lse2 = torch.logsumexp(lw[:n], 0), torch.logsumexp(2 * lw[:n], 0)
    w = torch.exp(lw - lse)
    w[n:] = 0.0
    rows, gate = rs.merge_resample_gated(p, lw, lse, lse2, n, 0.25,
                                         float(n), pass2=pass2)
    assert gate.tolist() == [True, True]
    want = rs.merge_resample_rows(p, w, n, 0.25, device="cpu", pass2=pass2)
    assert torch.equal(rows, want) and not rows[:, n:].any()


@pytest.mark.parametrize("noise_on", [False, True])
def test_step_kernel_twin_reads_the_gate(rng, noise_on):
    """K2b's twin with the device gate ``[take, restart]`` equals its host
    flag: ``[0, 0]`` as flag 0, ``[0, 1]`` as flag 1, and ``[1, 1]``
    steps ``p_alt`` as flag 1 steps those rows."""
    n = 1000
    cfg = _cfg("merge", 0.5, n)
    p = torch.from_numpy((rng.normal(size=(3, n)) * 0.3
                          + [[10.0], [0.0], [1.5]]).astype(np.float32))
    alt = p + 0.1
    lw = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(5, 2)).astype(np.float32))
    args = (cfg, 77)
    for take, restart in ((False, False), (False, True), (True, True)):
        gate = torch.tensor([take, restart])
        got = pf_cuda.pf_step_rows_plain(*args, 0.0, p, lw, z, noise_on,
                                         gate=gate, p_alt=alt)
        want = pf_cuda.pf_step_rows_plain(*args, float(restart),
                                          alt if take else p, lw, z,
                                          noise_on)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="p_alt"):
        pf_cuda.pf_step_rows_plain(*args, 0.0, p, lw, z, noise_on,
                                   gate=torch.tensor([False, False]))


def test_kernel_interfaces_mirror_the_source():
    """K3a's block and tile, and the C signatures of K3a, the single K3b
    and K2b with its gate, as the wrappers declare them for ctypes."""
    src = (_build.CSRC_DIR / "resample.cu").read_text()
    assert re.search(r"kBoundThreads = (\d+)", src).group(1) == str(
        rs.BOUND_THREADS)
    assert "kTile = 4 * kBoundThreads" in src and rs.TILE == 4 * 256
    declared = {}

    class Lib:
        def __getattr__(self, name):
            fn = declared.setdefault(name, type("Fn", (), {})())
            return fn

    _build._declare(Lib())
    sources = {"resample.cu": src,
               "pf_step.cu": (_build.CSRC_DIR / "pf_step.cu").read_text()}
    for name, source in (("tpuslam_resample_boundary", "resample.cu"),
                         ("tpuslam_resample_expand", "resample.cu"),
                         ("tpuslam_resample_arrivals", "resample.cu"),
                         ("tpuslam_pf_step", "pf_step.cu")):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', sources[source],
                        re.S).group(1)
        assert len(sig.split(",")) == len(declared[name].argtypes), name
    assert "const unsigned char* gate, const float* p_alt" in sources[
        "pf_step.cu"]
