"""The PF kernels' landmark quotients on a CUDA card: the compiled law
against the IEEE quotient on every float32, and the count of the passes
that needed the IEEE divide, on the batched filter's traffic and on
rare inputs.

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
