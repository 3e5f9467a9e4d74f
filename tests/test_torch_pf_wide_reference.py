"""The wide particle filter's loop (``pf_batch_wide_rollout``) on the CPU,
where the plain twins of K5a, the segmented expand and K5b stand in for
the kernels, against the benchmark's plain reference of the wide law
(``bench_torch/reference/pf_wide.py``), at B = 3 filters of n = 2,500
particles (three 1024-particle tiles, the last one ragged) for 24 steps,
noise on, on seeded comb offsets and observation noise.

Tolerances.  The reference computes the same float32 law with torch's own
sin, cos, exp and log where the twins take the kernels' polynomial
sincos and Box-Muller, and sums each row of weights in another order, so
the two differ by a few float32 ulps a step.  Until a filter's first
resample nothing but rounding separates them: its gate fires on the same
step, its estimates lie within 1e-4 m (about 10 m from the origin a
float32 ulp is 9.5e-7 m; 40 seeds measured at most 9.6e-7 m) and its
normalizers within 1e-4 of 1 + their size (measured 4.8e-6).  At a
resample an ulp can move a quantized weight across a rounding edge, so a
slot may take the neighbour of the reference's particle; from there the
two clouds are draws of one posterior and a filter's MAP estimate jumps
between them by the cloud's spread (up to 0.29 m measured).  So after the
first resample only the firing count of each filter must agree to one
(40 seeds: equal), and the mean estimate gap over every filter and step
must stay under 0.06 m (40 seeds measured at most 0.033 m).  The
reference in bfloat16 (8 bits of mantissa) fails each: before any
resample its estimates are 0.095-0.26 m off and its normalizers 0.1-2.6
of 1 + their size, its mean estimate gap is 0.12-0.17 m, and in 25 of 40
seeds it fires on another step.

Every tensor here stays under torch's 32,768-element grain (7,500 a
row set)."""

import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from tpuslam_torch.filters.pf import PfConfig
from tpuslam_torch.ops import pf_batch_cuda as pb

B, N, T = 3, 2500, 24
HARNESS = pathlib.Path(__file__).resolve().parents[1] / "bench_torch"
SCENE = json.loads((HARNESS / "configs" / "pf_loc_wide.json").read_text())["scene"]
EST_ATOL = 1e-4  # m, before a filter's first resample
LSE_REL = 1e-4  # of 1 + |lse|, before a filter's first resample
MEAN_EST_ATOL = 0.06  # m, the mean gap over every filter and step


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, str(HARNESS))
    try:
        spec = importlib.util.spec_from_file_location(
            "pf_wide_reference", HARNESS / "reference" / "pf_wide.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(HARNESS))
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(n=N):
    fields = {k: tuple(map(tuple, v)) if k == "landmarks" else
              tuple(v) if isinstance(v, list) else v
              for k, v in SCENE.items()}
    return PfConfig(num_particles=n, **fields)


def _inputs(seed, b=B):
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((T, b, len(SCENE["landmarks"]), 2), generator=g)
    noise = noise * torch.tensor(SCENE["r_std"])
    return noise, torch.rand((T, b), generator=g)


def _program(seed, pass2="windowed"):
    noise, offs = _inputs(seed)
    return pb.pf_batch_wide_rollout(_cfg(), None, B, T, device="cpu",
                                    obs_noise=noise, offs=offs, pass2=pass2)


def _reference(ref, seed, filt, dtype=torch.float32):
    noise, offs = _inputs(seed)
    f = torch.tensor(filt, dtype=torch.int64)
    return ref.filters(SCENE, N, B, f, T, noise[:, f], offs[:, f], dtype)


def _gaps(outs, want, filt):
    """The comparison of the module docstring: ``{name: bool}``, each True
    where the program holds to the reference."""
    f = list(filt)
    fired, ref_fired = outs.resampled[:, f], want["fired"]
    first = torch.where(ref_fired.any(0), ref_fired.int().argmax(0), T)
    step = torch.arange(T)[:, None]
    before, through = step < first, step <= first
    est = torch.linalg.vector_norm(outs.x_est[:, f, :2]
                                   - want["x_est"][..., :2].float(), dim=-1)
    lse, ref_lse = outs.lse[:, f], want["lse"].float()
    lse_gap = (lse - ref_lse).abs() / (1.0 + ref_lse.abs())
    return {
        "gate through the first resample":
            torch.equal(fired[through], ref_fired[through]),
        "firing counts": bool(((fired.sum(0) - ref_fired.sum(0)).abs()
                               <= 1).all()),
        "estimates before it": bool((est[before] <= EST_ATOL).all()),
        "normalizers before it": bool((lse_gap[before] <= LSE_REL).all()),
        "mean estimate gap": float(est.mean()) <= MEAN_EST_ATOL}


@pytest.mark.parametrize("seed", [3, 2**33 + 17, 9001])
def test_plain_path_is_the_reference_law(ref, seed):
    """Each filter fires as the reference's, its estimates and normalizers
    within the tolerances; the steps include resamples and steps that
    carry the unnormalized log weights on."""
    _, outs = _program(seed)
    want = _reference(ref, seed, range(B))
    assert 0 < int(want["fired"].sum()) < T * B
    assert all(_gaps(outs, want, range(B)).values())
    assert bool(torch.isfinite(outs.lse).all())


def test_bfloat16_reference_fails_the_tolerances(ref):
    """The control, the reference in bfloat16 in the program's place, fails
    each tolerance but the firing counts'."""
    _, outs = _program(3)
    held = _gaps(outs, _reference(ref, 3, range(B), torch.bfloat16),
                 range(B))
    del held["firing counts"], held["gate through the first resample"]
    assert not any(held.values()), held


def test_pass2_forms_agree_bit_for_bit():
    """``pass2="compressed"`` (the segmented K3c and K3d's twins) gives the
    windowed expand's rollout bit for bit."""
    a_final, a_outs = _program(5)
    b_final, b_outs = _program(5, pass2="compressed")
    for a, b in zip(tuple(a_final) + tuple(a_outs),
                    tuple(b_final) + tuple(b_outs)):
        assert torch.equal(a, b)


def test_subset_is_keyed_as_in_the_whole_batch(ref):
    """The reference run on filters [2, 0] of the batch gives those
    filters' rows of its whole-batch run, and they hold against the
    program's filters 2 and 0: a filter's noise is keyed by its index and
    by the call's batch, not by its place in the subset."""
    whole = _reference(ref, 9, range(B))
    part = _reference(ref, 9, [2, 0])
    for key in ("x_est", "lse", "fired"):
        torch.testing.assert_close(part[key], whole[key][:, [2, 0]], rtol=0,
                                   atol=0)
    torch.testing.assert_close(part["particles"], whole["particles"][[2, 0]],
                               rtol=0, atol=0)
    _, outs = _program(9)
    assert all(_gaps(outs, part, [2, 0]).values())


def test_seed_stride_is_the_calls_batch(ref):
    """The key advances by ``max(7919, B * ceil(n / 1024))`` with the
    call's B, as the program's ``wide_seed_step``, whatever subset the
    reference computes."""
    for b, n in ((3, 2500), (1024, 10000), (7920, 8), (1, 1)):
        assert ref.seed_step(n, b) == pb.wide_seed_step(_cfg(n), b)
    assert ref.seed_step(10000, 1024) == 10240


def test_rollout_carries_the_gate_its_k5b_writes():
    """The rollout reads each step's gate from the step before's K5b
    (its twin here: :func:`_gate` of the normalizers it returns):
    stepping the rollout's own truth, observations and keys, each step on
    torch's gate of its state, gives the rollout bit for bit."""
    cfg = _cfg()
    noise, offs = _inputs(11)
    final, outs = pb.pf_batch_wide_rollout(cfg, None, B, T, device="cpu",
                                           obs_noise=noise, offs=offs)
    x_tbl, z_clean = pb._truth_tables(cfg, pb.pf_batch_wide_init(
        cfg, B, device="cpu"), T, True)
    state = pb.pf_batch_wide_init(cfg, B, device="cpu")
    seed, stride = pb.SEED0, pb.wide_seed_step(cfg, B)
    for k in range(T):
        z = (z_clean[k] + noise[k]).contiguous()
        state, out, _ = pb._wide_step_core(
            cfg, state, x_tbl[k], z, seed, offs[k], True, None, "windowed",
            pb._gate(cfg, state.lse, state.lse2))
        for got, want in zip(out[1:], (outs.x_est[k], outs.ess[k],
                                       outs.lse[k], outs.resampled[k],
                                       outs.bad[k])):
            assert torch.equal(got, want)
        seed += stride
    for got, want in zip(state, final):
        assert torch.equal(got, want)
    _, _, lse, lse2, _, gate = pb.wide_stats_rows_plain(
        cfg, 3, state.particles, state.log_w, z, outs.bad[-1],
        outs.resampled[-1])
    for got, want in zip(gate, pb._gate(cfg, lse, lse2)):
        assert torch.equal(got, want)
