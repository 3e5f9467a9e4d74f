"""K1's launch path on a CUDA card: the current stream, the plan cache's
key, the seed's two key words folded by the library's entry, and the
small-batch form's outputs against the one-thread form's, word for word.

Every test needs a card and skips without one (the kernel has no CPU
mode); on a card run them with
``python -m pytest -m card tests/test_torch_ekf_card.py`` (the file imports
no JAX, which the card's machine lacks).
The bit-for-bit comparison of K1's outputs with another commit's is
``utils/turns.py``'s digests.
"""

import math

import pytest
import torch

from tpuslam_torch.filters import EkfConfig
from tpuslam_torch.ops import _build, ekf_cuda

pytestmark = pytest.mark.card

CFG = EkfConfig()
TWO_WORD_SEED = (0x1234ABCD << 32) | 0x9E37


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs only there")
    return torch.device("cuda", 0)


def _tensors(out):
    final, *acc = out
    return [*final, *acc]


def test_launch_under_a_side_stream_runs_on_it(dev):
    """A launch under ``torch.cuda.stream(side)`` goes to ``side``:
    captured into a CUDA graph on ``side``, it recomputes its outputs on
    replay (a launch on any other stream would be no part of the graph,
    and one on the legacy stream would break the capture)."""
    b, n = 1024, 33
    eager = _tensors(ekf_cuda.ekf_fused_rollout(CFG, TWO_WORD_SEED, b, n,
                                                with_nees=True, device=dev))
    side = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        assert torch.cuda.current_stream(dev) == side
        captured = _tensors(ekf_cuda.ekf_fused_rollout(
            CFG, TWO_WORD_SEED, b, n, with_nees=True, device=dev))
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize(dev)
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


def test_cuda_without_an_index_shares_the_plan(dev):
    """``"cuda"``, ``"cuda:0"`` and ``torch.device("cuda", 0)`` resolve to
    one key, so they build one plan, whatever the batch."""
    n = 29
    _build._CACHE.pop(("ekf_plan", CFG, n, dev), None)
    builds = _build.builds["ekf_plan"]
    launches = sum(_build.launches[form]
                   for form in ("ekf_rollout", "ekf_rollout_lanes"))
    outs = [ekf_cuda.ekf_fused_rollout(CFG, 3, b, n, device=where)
            for where, b in (("cuda", 64), ("cuda:0", 64),
                             (torch.device("cuda", 0), 64),
                             ("cuda", 4096))]
    torch.cuda.synchronize(dev)
    assert _build.builds["ekf_plan"] == builds + 1
    assert sum(_build.launches[form] for form in (
        "ekf_rollout", "ekf_rollout_lanes")) == launches + 4
    for out in outs[1:3]:
        for got, want in zip(_tensors(out), _tensors(outs[0])):
            assert torch.equal(got, want)
    # The Philox stream does not depend on the batch.
    for got, want in zip(_tensors(outs[3]), _tensors(outs[0])):
        assert torch.equal(got[:64], want)


@pytest.mark.parametrize("with_nees", [False, True])
@pytest.mark.parametrize("shape", [(8192, 400), (4096, 63)])
def test_philox_mode_draws_the_seed_stream(dev, shape, with_nees):
    """With both key words in play, the Philox rollout tracks the same
    rollout fed the stream's normals from plain torch: the entry folds
    ``seed_lo`` and ``seed_hi`` into the round keys as
    :func:`~tpuslam_torch.ops.fastmath.philox_round_keys` does.  The two
    differ only by the Box-Muller transform's rounding (chip_smoke.py's
    phase 4 tolerances); another key would part them by the noise."""
    b, n = shape
    normals = ekf_cuda.philox_normals(TWO_WORD_SEED, b, n, device=dev)
    drawn = ekf_cuda.ekf_fused_rollout(CFG, TWO_WORD_SEED, b, n,
                                       with_nees=with_nees, device=dev)
    fed = ekf_cuda.ekf_fused_rollout(CFG, TWO_WORD_SEED, b, n,
                                     with_nees=with_nees, normals=normals,
                                     device=dev)
    for name in ("x_true", "x_dr", "x_hat"):
        a, c = getattr(drawn[0], name), getattr(fed[0], name)
        yaw = torch.remainder(a[:, 2] - c[:, 2] + math.pi, 2 * math.pi)
        assert float((a[:, :2] - c[:, :2]).abs().max()) <= 1e-3, name
        assert float((yaw - math.pi).abs().max()) <= 1e-3, name
    a, c = drawn[0].cov, fed[0].cov
    assert bool(((a - c).abs() <= 1e-7 + 1e-4 * c.abs()).all())
    for a, c in zip(drawn[1:], fed[1:]):
        assert bool(((a - c).abs() <= 1e-6 + 1e-4 * c.abs()).all())


def _words(out):
    return [t.contiguous().view(torch.int32) for t in _tensors(out)]


@pytest.mark.parametrize("n_steps", [1, 2, 7, 64, 401])
@pytest.mark.parametrize("with_nees", [False, True])
@pytest.mark.parametrize("mode", ["off", "philox", "normals"])
def test_small_batch_form_equals_the_one_thread_form(dev, mode, with_nees,
                                                     n_steps):
    """A rollout's Philox stream does not depend on the batch, so rollouts
    0..B-1 of a launch in the small-batch form (four lanes a rollout) give
    the same output words as those rollouts of a launch large enough for
    the one-thread form; with injected normals, the large launch's first
    B columns hold the small launch's.  B = 1000 is no multiple of a
    block's 32 rollouts.  ``_build.launches["ekf_rollout_lanes"]`` counts
    the small launch only."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small, large = 1000, ekf_cuda.LANES_BELOW_PER_SM * sms
    assert ekf_cuda.k1_lanes(small, sms) == 4
    assert ekf_cuda.k1_lanes(large, sms) == 1
    kw = {"off": dict(noise_on=False), "philox": {}, "normals": {}}[mode]
    gen = torch.Generator(device=dev).manual_seed(n_steps)
    normals = torch.randn((n_steps, 5, large), generator=gen, device=dev)

    def launch(b):
        if mode == "normals":
            kw["normals"] = normals[:, :, :b].contiguous()
        return ekf_cuda.ekf_fused_rollout(CFG, TWO_WORD_SEED, b, n_steps,
                                          with_nees=with_nees, device=dev,
                                          **kw)

    lanes = _build.launches["ekf_rollout_lanes"]
    got = launch(small)
    assert _build.launches["ekf_rollout_lanes"] == lanes + 1
    want = launch(large)
    assert _build.launches["ekf_rollout_lanes"] == lanes + 1
    torch.cuda.synchronize(dev)
    for name, g, w in zip(["x_true", "x_dr", "x_hat", "cov", "sq_err",
                           "nees"], _words(got), _words(want)):
        assert torch.equal(g, w[:small]), name
