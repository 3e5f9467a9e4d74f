"""The PF kernels' landmark quotients on a CUDA card: the compiled law
against the IEEE quotient on every float32, and the count of the passes
that needed the IEEE divide, on the batched filter's traffic and on
rare inputs; the wide loop's spans and launches a step, and the ESS gate
K5b writes for the next step.

Every test needs a card and skips without one (the kernels have no CPU
mode); on a card run them with
``python -m pytest --noconftest -m card tests/test_torch_pf_card.py`` (the
file imports no JAX, which the card's machine lacks; ``--noconftest``
skips ``tests/conftest.py``, which does).  The model of the law and its
range is ``tests/test_torch_pf_divide.py``.
"""

import math

import pytest
import torch

from tpuslam_torch.filters import PfConfig
from tpuslam_torch.ops import _build
from tpuslam_torch.ops import pf_batch_cuda as pb

pytestmark = pytest.mark.card

#: pf_loc's r_std and two others.
DIVISORS = (0.3, 0.2, 3.0)
_CHUNK = 1 << 28  # bit patterns a launch
_MIN_A, _MAX_A = 2.0 ** -100, 2.0 ** 100  # pf_math.cuh's kDivMinA, kDivMaxA


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the PF kernels run only there")
    return torch.device("cuda", 0)


def _same(got, want):
    """Bit for bit, save that +0 and -0 and any two NaNs compare equal."""
    return ((got.view(torch.int32) == want.view(torch.int32)) | (got == want)
            | (torch.isnan(got) & torch.isnan(want)))


@pytest.mark.parametrize("s", DIVISORS)
def test_quotient_is_ieee_on_every_float32(dev, s):
    """The kernels' quotient of every float32 bit pattern by float32(s) is
    ``a / s``: float64's quotient rounded to float32, which is the
    correctly rounded float32 quotient (53 >= 2 * 24 + 2 bits).  The law
    alone is ``a / s`` on the whole exact range (0 and
    2^-100 <= |a| < 2^100)."""
    s32 = float(torch.tensor(s, dtype=torch.float32))
    den = torch.tensor(s32, dtype=torch.float64, device=dev)
    for start in range(0, 1 << 32, _CHUNK):
        bits = torch.arange(start, start + _CHUNK, dtype=torch.int64,
                            device=dev)
        a = bits.to(torch.int32).view(torch.float32)
        want = (a.double() / den).float()
        assert bool(_same(pb.div_by_const(a, s, law_only=False), want).all())
        mag = a.abs()
        exact = (mag == 0) | ((mag >= _MIN_A) & (mag < _MAX_A))
        law = pb.div_by_const(a, s, law_only=True)
        assert bool(_same(law, want)[exact].all())


def _step_inputs(dev, b: int, n: int, seed: int = 3):
    """K4's inputs at b x n: clouds around x0, uniform log weights (the
    gate closed), one noisy observation a filter."""
    from tpuslam_torch.core.se2 import world_to_robot

    cfg = PfConfig(num_particles=n, weight_mode="log",
                   ess_threshold_frac=0.01)
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(cfg.x0, **f32)
    spread = torch.tensor([0.5, 0.5, 0.2], **f32)
    parts = (x0[:, None, None] + spread[:, None, None]
             * torch.randn((3, b, n), generator=g, **f32)).contiguous()
    lw = torch.zeros((b, n), **f32)
    lse = torch.full((b,), math.log(n), **f32)
    z = world_to_robot(x0, torch.tensor(cfg.landmarks, **f32))
    z = (z + 0.3 * torch.randn((b,) + z.shape, generator=g, **f32))
    return cfg, parts, lw, lse, z.contiguous()


def _k4_count(dev) -> int:
    return _build.div_fallbacks(dev)["pf_batch_step"]


def test_rare_operands_fall_back_with_the_same_bits(dev):
    """Particles 8-15 of filter 1 at x = 1e35 (their operands past 2^100)
    and of filter 3 at inf make one counted pass each (warp 0 of a
    filter's one pass); an observation coordinate of filter 2 at 0 sends
    its warps to the IEEE divide uncounted.  Every other particle's log
    weight and pose equal the ones of the same step without them, bit for
    bit: where the law was exact the IEEE divide gives its bits."""
    cfg, parts, lw, lse, z = _step_inputs(dev, 16, 1000)
    base = pb.pf_batch_step_rows(cfg, 5, parts, lw, lse, lse, z)
    rare_parts, rare_z = parts.clone(), z.clone()
    rare_parts[0, 1, 8:16] = 1e35
    rare_parts[0, 3, 8:16] = math.inf
    rare_z[2, 0, 0] = 0.0
    before = _k4_count(dev)
    rare = pb.pf_batch_step_rows(cfg, 5, rare_parts, lw, lse, lse, rare_z)
    torch.cuda.synchronize(dev)
    assert (_k4_count(dev) - before) % 2 ** 32 == 2
    assert not bool(rare.resampled.any())
    keep = torch.ones_like(lw, dtype=torch.bool)
    keep[1, 8:16] = keep[3, 8:16] = False
    keep[2] = False
    for got, want in ((rare.log_w, base.log_w), *zip(rare.particles,
                                                     base.particles)):
        assert torch.equal(got[keep], want[keep])
    assert bool(torch.isneginf(rare.log_w[1, 8:16]).all())
    # Filter 2 took the IEEE divide on its own observation: its row is the
    # kernel's, finite, and as the plain twin's to rounding.
    plain = pb.pf_batch_step_rows_plain(cfg, 5, rare_parts, lw, lse, lse,
                                        rare_z)
    assert bool(torch.isfinite(rare.log_w[2]).all())
    torch.testing.assert_close(rare.log_w[2], plain.log_w[2], rtol=1e-4,
                               atol=1e-3)


def test_no_fallback_on_the_batched_cells_traffic(dev):
    """A 50-step ``pf_batch_rollout`` at 8192 x 1000, Philox noise (the
    batched cell's traffic), takes no pass to the IEEE divide."""
    cfg = PfConfig(num_particles=1000, weight_mode="log",
                   ess_threshold_frac=0.01)
    before = _build.div_fallbacks(dev)
    launches = _build.launches["pf_batch_step"]
    pb.pf_batch_rollout(cfg, torch.Generator(device=dev).manual_seed(11),
                        8192, 50, device=dev)
    torch.cuda.synchronize(dev)
    assert _build.launches["pf_batch_step"] - launches == 50
    assert _build.div_fallbacks(dev) == before


#: The launch forms of a wide step by its pass B.
WIDE_FORMS = {"windowed": ("wide_boundary", "resample_expand_seg",
                           "wide_stats"),
              "compressed": ("wide_boundary", "compact_seg",
                             "expand_compressed_seg", "wide_stats")}


@pytest.mark.parametrize("pass2", sorted(WIDE_FORMS))
def test_wide_rollout_spans_and_launches(dev, pass2):
    """A 30-step ``pf_batch_wide_rollout`` at 64 x 10,000 under the
    profiler records one ``tpuslam.pf_wide.rollout`` and ``.prepare``, 30
    ``.step`` and 30 ``.resample`` spans, and launches each kernel form
    of its pass B once a step and no form of the other."""
    from tpuslam_torch.utils.profiling import span_totals

    cfg = PfConfig(num_particles=10000, weight_mode="log",
                   ess_threshold_frac=0.01)
    forms = set(WIDE_FORMS["windowed"] + WIDE_FORMS["compressed"])
    before = {f: _build.launches[f] for f in forms}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pb.pf_batch_wide_rollout(
            cfg, torch.Generator(device=dev).manual_seed(11), 64, 30,
            device=dev, pass2=pass2)
        torch.cuda.synchronize(dev)
    counts = {name: row["count"] for name, row in
              span_totals(prof.events()).items()
              if name.startswith("tpuslam.pf_wide.")}
    assert counts == {"tpuslam.pf_wide.rollout": 1,
                      "tpuslam.pf_wide.prepare": 1,
                      "tpuslam.pf_wide.step": 30,
                      "tpuslam.pf_wide.resample": 30}
    assert {f: _build.launches[f] - before[f] for f in forms} == {
        f: 30 if f in WIDE_FORMS[pass2] else 0 for f in forms}


def test_k5b_writes_the_torch_gate_of_its_normalizers(dev):
    """K5b's next-step ESS gate is ``_gate`` of the ``lse``, ``lse2`` it
    writes, bit for bit, on a cloud 30 steps into a 1024 x 10,000 rollout
    with two filters' log weights made NaN and -inf (their gate is bad);
    and a 30-step rollout, which carries K5b's gates, equals its steps
    taken with torch's gate of each state."""
    cfg = PfConfig(num_particles=10000, weight_mode="log",
                   ess_threshold_frac=0.01)
    b, steps = 1024, 30
    g = torch.Generator(device=dev).manual_seed(7)
    f32 = dict(dtype=torch.float32, device=dev)
    noise = 0.3 * torch.randn((steps, b, 5, 2), generator=g, **f32)
    offs = torch.rand((steps, b), generator=g, **f32)
    final, outs = pb.pf_batch_wide_rollout(cfg, None, b, steps, device=dev,
                                           obs_noise=noise, offs=offs)
    state = pb.pf_batch_wide_init(cfg, b, device=dev)
    x_tbl, z_clean = pb._truth_tables(cfg, state, steps, True)
    seed = pb.SEED0
    for k in range(steps):
        z = (z_clean[k] + noise[k]).contiguous()
        state, out, _ = pb._wide_step_core(
            cfg, state, x_tbl[k], z, seed, offs[k], True, None, "windowed",
            pb._gate(cfg, state.lse, state.lse2))
        for got, want in zip(out[1:], (outs.x_est[k], outs.ess[k],
                                       outs.lse[k], outs.resampled[k],
                                       outs.bad[k])):
            assert torch.equal(got, want), k
        seed += pb.wide_seed_step(cfg, b)
    assert bool(outs.resampled.any())
    lw = final.log_w.clone()
    lw[3] = math.nan
    lw[5] = -math.inf
    bad, _, fire = pb._gate(cfg, final.lse, final.lse2)
    *_, lse, lse2, _, gate = pb.wide_stats_rows(
        cfg, 99, final.particles, lw, z, bad, fire)
    want = pb._gate(cfg, lse, lse2)
    assert torch.equal(gate[0], want[0]) and torch.equal(gate[2], want[2])
    assert torch.equal(gate[1].view(torch.int32), want[1].view(torch.int32))
    assert bool(gate[0][3]) and bool(gate[0][5])
    assert int(gate[0].sum()) == 2
