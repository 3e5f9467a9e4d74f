"""The large solve's scene axis on a CUDA card, where
``slam/tridiag.py::factor_resolver`` replays the scene-axis factor and its
resolves as CUDA graphs: each replay equals the eager factor and resolve,
bit for bit, on the inputs of that call; a resolver whose factor a later
one of the same shape replaced refuses to run; the public factors own
their tensors; and a batched solve on the card agrees with the same solve
on the CPU.

Every test needs a card and skips without one (CUDA graphs exist only
there); on a card run them with
``python -m pytest --noconftest -m card tests/test_torch_slam_large_card.py``
(the file imports no JAX, which the card's machine lacks).
"""

import math

import pytest
import torch

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.models.scan_sensor import ScanConfig
from tpuslam_torch.slam import large, tridiag
from tpuslam_torch.slam.graph import GraphConfig, GraphObservations

pytestmark = pytest.mark.card

S, BAND, T1 = 3, 4, 40


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs run only there")
    return torch.device("cuda", 0)


def _chain(seed, dev):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((S, (BAND + 1) * 9, T1), generator=g) * 0.1
    h[:, 0:9:4] += 10.0  # diagonally dominant: positive definite
    return h.to(dev), torch.randn((S, 3, T1), generator=g).to(dev)


def _eager(h, b):
    fac = tridiag.banded_factor_tridiag_flat(h, BAND)
    return tridiag.banded_resolve_tridiag_flat(fac, b, BAND)


def test_replays_equal_the_eager_chain(dev):
    """Three factors of one shape (the first captures, the others replay
    with new inputs), each resolved twice, against the eager factor and
    resolve."""
    for seed in range(3):
        h, b = _chain(seed, dev)
        resolve = tridiag.factor_resolver(h, BAND, BAND)
        for rhs in (b, 2.0 * b):
            assert torch.equal(resolve(rhs), _eager(h, rhs))


def test_a_replaced_resolver_refuses_to_run(dev):
    (h_a, b_a), (h_b, _) = _chain(0, dev), _chain(1, dev)
    resolve_a = tridiag.factor_resolver(h_a, BAND, BAND)
    tridiag.factor_resolver(h_b, BAND, BAND)
    with pytest.raises(RuntimeError, match="replaced"):
        resolve_a(b_a)


def test_the_graphs_kept_are_bounded(dev):
    for t1 in (T1, 2 * T1, 3 * T1):
        h, b = _chain(0, dev)
        h = h.repeat(1, 1, t1 // T1)
        tridiag.factor_resolver(h, BAND, BAND)
    assert len(tridiag._GRAPHS) <= tridiag._GRAPHS_KEPT


def test_factors_of_one_shape_own_their_tensors(dev):
    """Factor A, then B of the same shape, then resolve with A."""
    (h_a, b_a), (h_b, _) = _chain(0, dev), _chain(1, dev)
    fac_a = tridiag.banded_factor_tridiag_flat(h_a, BAND)
    tridiag.banded_factor_tridiag_flat(h_b, BAND)
    got = tridiag.banded_resolve_tridiag_flat(fac_a, b_a, BAND)
    assert torch.equal(got, _eager(h_a, b_a))


def _scenes(n=200, lms=20, w=30):
    cfg = GraphConfig(max_times=n, num_landmarks=lms, max_gn_iters=10,
                      scan=ScanConfig(range_m=15.0,
                                      angle_rad=math.radians(80.0),
                                      dist_gain=0.05,
                                      dir_sigma=math.radians(2.0),
                                      orient_sigma=math.radians(2.0)),
                      exact_jacobians=True)
    scenes = [large.make_large_scene(cfg, torch.Generator().manual_seed(s),
                                     n, lms, radius=0.3 * n, odom_noise=0.1,
                                     device="cpu") for s in range(S)]
    lists = [large.window_pairs_device(o.valid, w, 40 * n)
             for _, _, o in scenes]
    e = max(int(c) for _, c in lists)
    edges = large.EdgeList(*(torch.stack([f[:e] for f in fields])
                             for fields in zip(*(el for el, _ in lists))))
    poses = torch.stack([po for _, po, _ in scenes])
    obs = GraphObservations(*(torch.stack(f) for f in
                              zip(*(o for _, _, o in scenes))))
    rel = poses[:, 1:] - poses[:, :-1]
    rel = torch.cat([rel[..., :2], wrap_angle(rel[..., 2:])], dim=-1)
    return cfg, poses, obs, edges, rel, w, n


def _solve(cfg, poses, obs, edges, rel, w, n, dev):
    def to(x):
        return type(x)(*(t.to(dev) for t in x)) if isinstance(
            x, tuple) else x.to(dev)
    return large.graph_solve_banded(
        cfg, to(poses), to(obs), to(edges), band=w, rel_odom=to(rel),
        odom_info=(100.0,) * 3, solver="tridiag", stall_ratio=0.5,
        delta_tol=1e-6 * n)


def test_batched_solve_on_the_card_matches_the_cpu(dev):
    """``bench_graph_large``'s settings at 200 poses, three scenes: the
    card's lockstep solve (twice: capture, then replay) against the
    CPU's, equal GN iterations and poses within 1e-4 m."""
    args = _scenes()
    want = _solve(*args, torch.device("cpu"))
    for _ in range(2):
        got = _solve(*args, dev)
        assert torch.equal(got.gn_iters.cpu(), want.gn_iters)
        torch.testing.assert_close(got.poses.cpu(), want.poses, rtol=0,
                                   atol=1e-4)
