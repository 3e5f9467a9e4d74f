"""K6, the Thomas factor's chain as one hand-written kernel
(``csrc/thomas_factor.cu`` through ``ops/thomas_cuda.py``), on a CUDA card
against its plain twin, the torch chain
``slam/tridiag.py::block_thomas_factor_plain`` (cuSOLVER's Cholesky,
cuBLAS's triangular solve and products).

The inputs are prescaled chains of seeded 10k-pose scenes (the benchmark
cell's sizes: ``N = 250`` super-blocks of ``M = 120``), densified as the
large solve densifies them.  K6 and the plain chain round differently:
their float32 products of depth 120 sum in other orders, and their
Cholesky factors and triangular inverses are other algorithms of the same
algebra.  So neither is held to the other bit for bit; each is held to the
same chain in float64 (the plain chain on the float64 copy of the same
inputs), and K6's error there may be at most twice the plain chain's plus
a floor of a few float32 roundings of the largest entry.  Every test needs
a card and skips without one; on a card run them with
``python -m pytest --noconftest -m card tests/test_torch_slam_thomas_card.py``
(the file imports no JAX, which the card's machine lacks).
"""

import math

import pytest
import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.models.scan_sensor import ScanConfig
from tpuslam_torch.ops import _build, thomas_cuda
from tpuslam_torch.slam import large, tridiag
from tpuslam_torch.slam.graph import GraphConfig

pytestmark = pytest.mark.card

#: The cell's scene: poses, landmarks, window (the super-block size, so M
#: = 3 x 40 = 120), odometry noise and information.
POSES, LANDMARKS, WINDOW = 10_000, 1000, 40
ODOM_NOISE, ODOM_INFO = 0.1, (100.0, 100.0, 100.0)
#: The cell's scenes a call.
SCENES = 32
#: K6's error against float64 may be this many times the plain chain's...
ERR_RATIO = 2.0
#: ... plus this share of the float64 field's largest entry (a few float32
#: roundings: 2^-24 is 6e-8).
ERR_FLOOR = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 runs only there")
    return torch.device("cuda", 0)


def scene_system(seed: int, dev) -> torch.Tensor:
    """The flat banded H, ``((WINDOW+1)*9, POSES)``, of a seeded scene at
    the cell's sizes, frozen Omega and exact Jacobians (the reuse path's
    constant H, ``slam/large.py::_constant_h``)."""
    cfg = GraphConfig(
        max_times=POSES, num_landmarks=LANDMARKS, max_gn_iters=10,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)),
        exact_jacobians=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, po, obs = large.make_large_scene(
        cfg, gen, POSES, LANDMARKS, radius=0.3 * POSES,
        odom_noise=ODOM_NOISE, device=dev)
    edges, _ = large.window_pairs_device(obs.valid, WINDOW,
                                         8 * WINDOW * POSES)
    rel = po[1:] - po[:-1]
    rel = torch.cat([rel[:, :2], wrap_angle(rel[:, 2:])], dim=1)
    scatter = large.build_banded_scatter(edges, POSES, WINDOW)
    om, _, mask = large.exact_edge_terms(cfg, obs, edges, po)
    h_flat, _ = large._constant_h(cfg, po, om, mask, edges, POSES, WINDOW,
                                  rel, ODOM_INFO, 0.0, scatter)
    return h_flat


def prescaled_chain(h_flat: torch.Tensor):
    """``(diag, upper)`` of the large solve's factor: the flat system
    padded, Jacobi-prescaled and densified into super-blocks of WINDOW
    poses (``tridiag.banded_factor_tridiag_flat``'s steps); a leading
    scene axis comes out after the chain axis."""
    zeros = h_flat.new_zeros((*h_flat.shape[:-2], 3, h_flat.shape[-1]))
    h_pad, b_pad = tridiag.pad_flat(h_flat, zeros, WINDOW)
    h_s, _, _ = tridiag._flat_prescale(h_pad, b_pad, WINDOW)
    return tridiag._flat_to_tridiag(h_s, WINDOW, WINDOW)


@pytest.fixture(scope="module")
def cell_chain(dev):
    """The cell's chain: SCENES seeded scenes, ``(250, 32, 120, 120)``."""
    return prescaled_chain(torch.stack([scene_system(s, dev)
                                        for s in range(SCENES)]))


def factor_error(fac, ref) -> dict:
    """Each field's largest gap to ``ref``'s over its largest entry."""
    return {name: float((getattr(fac, name).double() - want).abs().max()
                        / want.abs().max())
            for name, want in (("invs", ref.invs), ("ws", ref.ws))}


def held_to_float64(diag, upper) -> dict:
    """K6 and the plain chain on ``(diag, upper)``, each against the plain
    chain in float64: ``{field: (K6's error, the plain's)}``; raises
    unless K6's is within ERR_RATIO x the plain's + ERR_FLOOR."""
    ref = tridiag.block_thomas_factor_plain(diag.double(), upper.double())
    k6 = tridiag.block_thomas_factor(diag, upper)
    plain = tridiag.block_thomas_factor_plain(diag, upper)
    e6, ep = factor_error(k6, ref), factor_error(plain, ref)
    for name in e6:
        assert e6[name] <= ERR_RATIO * ep[name] + ERR_FLOOR, (name, e6, ep)
    return {name: (e6[name], ep[name]) for name in e6}


def test_cell_shape_as_accurate_as_the_plain_chain(dev, cell_chain):
    diag, upper = cell_chain
    assert thomas_cuda.fits(diag)
    assert diag.shape == (250, SCENES, 120, 120)
    held_to_float64(diag, upper)


def test_one_scene_as_accurate_as_the_plain_chain(dev):
    diag, upper = prescaled_chain(scene_system(SCENES, dev))
    assert diag.shape == (250, 120, 120)
    held_to_float64(diag, upper)


def test_partitioned_chunks_as_accurate_as_the_plain_chain(dev):
    """The partitioned factor's chunk chain at 10 chunks: depth 24,
    batched over the chunks (time-major views, made contiguous)."""
    diag, upper = prescaled_chain(scene_system(SCENES + 1, dev))
    c = 10
    m = diag.shape[0] // c
    up_r = torch.cat([upper, upper[:1] * 0]).reshape(c, m, 120, 120)
    a_int = diag.reshape(c, m, 120, 120)[:, :m - 1].transpose(0, 1)
    u_int = up_r[:, :m - 2].transpose(0, 1)
    held_to_float64(a_int.contiguous(), u_int.contiguous())
    fac = tridiag.block_thomas_factor_partitioned(diag, upper, c)
    assert bool(fac.red.invs.isfinite().all())


def _random_chain(dev, n=20, batch=4, m=24, seed=0):
    """A small diagonally dominant (so positive definite) chain."""
    g = torch.Generator().manual_seed(seed)
    diag = torch.randn((n, batch, m, m), generator=g) * 0.1
    diag = diag + diag.mT + 4.0 * torch.eye(m)
    upper = torch.randn((n - 1, batch, m, m), generator=g) * 0.1
    return diag.to(dev), upper.to(dev)


def test_block_off_the_panel_as_accurate_as_the_plain_chain(dev):
    """M = 90, the super-block of a window of 30 (the 200-pose scene's and
    its partitioned chains'): K6 factors it bordered up to 96."""
    diag, upper = _random_chain(dev, n=40, batch=3, m=90, seed=5)
    assert thomas_cuda.fits(diag)
    held_to_float64(diag, upper)


def test_a_chain_k6_cannot_take_is_refused(dev):
    """No chain on the card falls to the plain chain unasked: float64 and
    super-blocks past K6's plan raise (a float64 reference names
    ``block_thomas_factor_plain``)."""
    diag, upper = _random_chain(dev, n=4, batch=2, m=24, seed=6)
    with pytest.raises(ValueError, match="diag dtype"):
        tridiag.block_thomas_factor(diag.double(), upper.double())
    diag, upper = _random_chain(dev, n=3, batch=1, m=136, seed=7)
    with pytest.raises(ValueError, match="super-block size 136"):
        tridiag.block_thomas_factor(diag, upper)


@pytest.mark.parametrize("m", [24, 30])
def test_not_positive_definite_gives_nan_in_that_matrix_only(dev, m):
    """At M = 24 and at M = 30, bordered to 32."""
    diag, upper = _random_chain(dev, m=m)
    clean = tridiag.block_thomas_factor(diag, upper)
    bad = diag.clone()
    bad[5, 2] = -torch.eye(m, device=dev)
    fac = tridiag.block_thomas_factor(bad, upper)
    assert bool(fac.invs[5:, 2].isnan().all())
    assert bool(fac.invs[:5, 2].isfinite().all())
    assert bool(fac.ws[6:, 2].isnan().all())
    assert torch.equal(fac.ws[:6, 2], clean.ws[:6, 2])
    keep = [0, 1, 3]
    assert torch.equal(fac.invs[:, keep], clean.invs[:, keep])
    assert torch.equal(fac.ws[:, keep], clean.ws[:, keep])
    assert torch.equal(fac.invs[:5], clean.invs[:5])


def test_two_launches_give_equal_bits(dev, cell_chain):
    a = thomas_cuda.thomas_factor(*cell_chain)
    b = thomas_cuda.thomas_factor(*cell_chain)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_graph_replay_equals_a_direct_launch(dev):
    diag, upper = _random_chain(dev, seed=1)
    d_in, u_in = diag.clone(), upper.clone()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        thomas_cuda.thomas_factor(d_in, u_in)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = thomas_cuda.thomas_factor(d_in, u_in)
    for seed in (2, 3):
        diag, upper = _random_chain(dev, seed=seed)
        d_in.copy_(diag)
        u_in.copy_(upper)
        graph.replay()
        want = thomas_cuda.thomas_factor(diag, upper)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_launch_count_rises_by_one_a_factor(dev):
    diag, upper = _random_chain(dev, seed=4)
    before = _build.launches["thomas_factor"]
    tridiag.block_thomas_factor(diag, upper)
    assert _build.launches["thomas_factor"] == before + 1
    # A scene-axis factor of the large solve: a CUDA graph whose replay is
    # one K6 launch (the first call also runs the chain once before its
    # capture).
    h = torch.randn((3, 9 * 9, 64), device=dev) * 0.01
    h[:, 0:9:4] += 10.0
    tridiag.factor_resolver(h, 8, 8)
    assert _build.launches["thomas_factor"] == before + 3
    tridiag.factor_resolver(h * 1.5, 8, 8)
    assert _build.launches["thomas_factor"] == before + 4
