"""K6's wrapper (``tpuslam_torch/ops/thomas_cuda.py``) on the CPU: the
cluster it picks, the predicate of the chains it takes, the border that
takes a super-block size off its panel, its refusals, and its launch
through the ``stand_in`` library.  K6 itself runs only on a card
(``tests/test_torch_slam_thomas_card.py``); on the CPU every chain runs
the plain twin.  This module imports no JAX.
"""

import collections
import re

import pytest
import torch

from tpuslam_torch.ops import _build, thomas_cuda
from tpuslam_torch.slam import tridiag
from test_torch_ops_launch import stand_in  # noqa: F401

F32 = torch.float32


#: An H100 80GB HBM3's most resident clusters of 1 .. 8 CTAs at M = 120
#: (``tpuslam_thomas_clusters`` on the card): its clusters sit within GPCs,
#: so 30 of 4 CTAs, not 33.
H100_RESIDENT = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("batch, resident, want", [
    (32, H100_RESIDENT, 3), (30, H100_RESIDENT, 4), (31, H100_RESIDENT, 3),
    (1, H100_RESIDENT, 8), (15, H100_RESIDENT, 8), (16, H100_RESIDENT, 6),
    (39, H100_RESIDENT, 3), (40, H100_RESIDENT, 2), (66, H100_RESIDENT, 2), (67, H100_RESIDENT, 1),
    (500, H100_RESIDENT, 1), (4, (8, 4, 2, 2), 2), (5, (8, 4, 2, 2), 1),
    (1, (1,), 1)])
def test_cluster_is_the_largest_whose_batch_is_resident(batch, resident,
                                                        want):
    assert thomas_cuda.cluster_size(batch, resident) == want


@pytest.mark.parametrize("shape, dtype, want", [
    ((250, 32, 120, 120), F32, True),  # the cell's chain
    ((250, 120, 120), F32, True),  # one scene
    ((24, 10, 120, 120), F32, True),  # partitioned chunks
    ((3, 8, 8), F32, True),
    ((3, 2, 128, 128), F32, True),
    ((3, 12, 12), F32, True),  # bordered to 16
    ((7, 90, 90), F32, True),  # a window of 30: bordered to 96
    ((3, 126, 126), F32, True),  # bordered to 128
    ((250, 32, 120, 120), torch.float64, False),
    ((3, 129, 129), F32, False),  # bordered past the shared-memory plan
    ((3, 136, 136), F32, False),
    ((3, 0, 0), F32, False),
    ((120, 120), F32, False),  # no chain axis
    ((3, 120, 112), F32, False)])
def test_predicate_by_dtype_and_shape(shape, dtype, want):
    assert thomas_cuda.fits(torch.empty(shape, dtype=dtype,
                                        device="meta")) is want


def test_fits_reads_the_tensor():
    assert thomas_cuda.fits(torch.zeros(3, 2, 8, 8))
    assert not thomas_cuda.fits(torch.zeros(3, 2, 8, 8, dtype=torch.float64))


@pytest.mark.parametrize("name, value", [("kMaxM", thomas_cuda.MAX_M),
                                         ("kPanel", thomas_cuda.PANEL),
                                         ("kMaxCluster",
                                          thomas_cuda.MAX_CLUSTER)])
def test_limits_are_the_sources(name, value):
    """The wrapper's limits are the kernel source's, which its C entries
    check again."""
    src = (_build.CSRC_DIR / "thomas_factor.cu").read_text()
    assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)]


def _chain(n=4, batch=(2,), m=8, dtype=F32):
    g = torch.Generator().manual_seed(0)
    diag = torch.randn((n, *batch, m, m), generator=g, dtype=dtype) * 0.1
    diag = diag + diag.mT + 4.0 * torch.eye(m, dtype=dtype)
    upper = torch.randn((n - 1, *batch, m, m), generator=g,
                        dtype=dtype) * 0.1
    return diag, upper


@pytest.mark.parametrize("what, make, match", [
    ("dtype", lambda d, u: (d.double(), u.double()), "diag dtype"),
    ("upper dtype", lambda d, u: (d, u.double()), "upper dtype"),
    ("upper shape", lambda d, u: (d, u[:-1]), "upper shape"),
    ("batch", lambda d, u: (d, u[:, :1]), "upper shape"),
    ("contiguity", lambda d, u: (d.mT, u), "diag must be contiguous"),
    ("upper contiguity", lambda d, u: (d, u.mT), "upper must be contiguous"),
    ("non-square", lambda d, u: (d[..., :4], u[..., :4]), "diag shape"),
    ("rank", lambda d, u: (d[0, 0], u[0, 0]), "diag must be"),
    ("alignment", lambda d, u: (torch.zeros(d.numel() + 1)[1:].view(
        d.shape), u), "diag must be 16-byte aligned"),
    ("device", lambda d, u: (d, u), "K6 takes CUDA tensors")])
def test_wrapper_refuses_naming_the_argument(what, make, match):
    with pytest.raises(ValueError, match=match):
        thomas_cuda.thomas_factor(*make(*_chain()))


@pytest.mark.parametrize("m", [129, 136])
def test_wrapper_refuses_a_block_past_the_plan(m):
    diag, upper = _chain(n=2, batch=(), m=m)
    with pytest.raises(ValueError, match=f"super-block size {m}"):
        thomas_cuda.thomas_factor(diag, upper)


@pytest.mark.parametrize("batch, cluster", [((32,), 3), ((), 8),
                                             ((2, 50), 1)])
def test_launch_passes_the_chain_and_its_cluster(stand_in, monkeypatch,
                                                 batch, cluster):
    """One entry call a factor: the pointers, N, the flattened batch, M,
    the cluster for an H100's resident clusters and the stream; one plan
    a device and M; one count."""
    monkeypatch.setattr(thomas_cuda, "_resident",
                        lambda lib, device, m: H100_RESIDENT)
    diag, upper = _chain(n=3, batch=batch, m=16)
    for _ in range(2):
        invs, ws = thomas_cuda._launch(diag, upper)
    assert invs.shape == ws.shape == diag.shape
    (name, args), = set((n, a[4:]) for n, a in stand_in.calls)
    assert name == "tpuslam_thomas_factor"
    flat = 1
    for b in batch:
        flat *= b
    assert args == (3, flat, 16, cluster, 77)
    assert stand_in.calls[0][1][:2] == (diag.data_ptr(), upper.data_ptr())
    assert _build.launches == {"thomas_factor": 2}
    assert _build.builds == {"thomas_factor": 1}


def test_launch_borders_a_block_off_the_panel(stand_in, monkeypatch):
    """M = 90 (a window of 30) launches bordered to 96, on fresh bordered
    copies, and comes back cut to 90."""
    monkeypatch.setattr(thomas_cuda, "_resident",
                        lambda lib, device, m: H100_RESIDENT)
    diag, upper = _chain(n=3, batch=(2,), m=90)
    invs, ws = thomas_cuda._launch(diag, upper)
    assert invs.shape == ws.shape == diag.shape
    assert invs.is_contiguous() and ws.is_contiguous()
    (name, args), = stand_in.calls
    assert args[4:] == (3, 2, 96, 8, 77)
    assert args[0] != diag.data_ptr() and args[1] != upper.data_ptr()
    assert _build.builds == {"thomas_factor": 1}


@pytest.mark.parametrize("m", [12, 90])
def test_bordered_chain_factors_to_the_chain_factor_bordered(m):
    """The border's Schur complements stay the identity and its multipliers
    zero, exactly; the chain's own blocks keep their values (float64, the
    plain chain, whose library sums may block differently at another
    size)."""
    diag, upper = _chain(n=6, batch=(3,), m=m, dtype=torch.float64)
    mb = -(-m // thomas_cuda.PANEL) * thomas_cuda.PANEL
    d, u = thomas_cuda.bordered(diag, upper, mb)
    assert torch.equal(d[..., :m, :m], diag)
    assert torch.equal(u[..., :m, :m], upper)
    got = tridiag.block_thomas_factor_plain(d, u)
    want = tridiag.block_thomas_factor_plain(diag, upper)
    eye = torch.eye(mb - m, dtype=torch.float64)
    assert torch.equal(got.invs[..., m:, m:], eye.expand_as(
        got.invs[..., m:, m:]))
    for t in (got.invs, got.ws):
        assert not t[..., :m, m:].any() and not t[..., m:, :m].any()
    assert not got.ws[..., m:, m:].any()
    for name in ("invs", "ws"):
        torch.testing.assert_close(getattr(got, name)[..., :m, :m],
                                   getattr(want, name), rtol=1e-12,
                                   atol=1e-14)


def test_one_step_chain_passes_no_upper(stand_in, monkeypatch):
    monkeypatch.setattr(thomas_cuda, "_resident",
                        lambda lib, device, m: H100_RESIDENT)
    diag, upper = _chain(n=1, batch=(), m=8)
    thomas_cuda._launch(diag, upper)
    assert stand_in.calls[0][1][1] is None


def test_the_cpu_runs_the_plain_chain(monkeypatch):
    """On the CPU ``block_thomas_factor`` is the torch chain, bit for bit,
    and launches nothing."""
    monkeypatch.setattr(_build, "launches", collections.Counter())
    diag, upper = _chain(n=5, batch=(3,), m=16)
    got = tridiag.block_thomas_factor(diag, upper)
    want = tridiag.block_thomas_factor_plain(diag, upper)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not _build.launches


def test_resident_clusters_read_from_the_card(stand_in):
    """The plan asks the library for the resident clusters at its M; a
    card that answers with an error raises, naming the entry."""
    lib_counts = thomas_cuda._resident(stand_in, torch.device("cpu"), 120)
    assert lib_counts == (0,) * thomas_cuda.MAX_CLUSTER
    name, args = stand_in.calls[-1]
    assert name == "tpuslam_thomas_clusters" and args[0] == 120
    stand_in.rc = 2
    with pytest.raises(RuntimeError, match="tpuslam_thomas_clusters"):
        thomas_cuda._resident(stand_in, torch.device("cpu"), 120)
