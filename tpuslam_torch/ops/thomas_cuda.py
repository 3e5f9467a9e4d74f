"""K6, the block-Thomas factor's step chain as one CUDA launch
(``csrc/thomas_factor.cu``).

:func:`~tpuslam_torch.slam.tridiag.block_thomas_factor` gives every chain
on a CUDA card to :func:`thomas_factor`, and every other chain, the CPU's
included, to the torch chain
:func:`~tpuslam_torch.slam.tridiag.block_thomas_factor_plain`, K6's plain
twin.  K6 takes a float32 chain whose super-blocks :func:`fits` its
shared-memory plan (M at most :data:`MAX_M`) and refuses any other,
naming the argument.  Its Cholesky runs in panels of :data:`PANEL`
columns: a chain whose M is not a multiple of it is bordered up to one
with identity diagonal blocks and zero coupling (:func:`bordered`), which
leaves the chain's own blocks of the factor as they are.

K6 gives each batch matrix a thread-block cluster of :func:`cluster_size`
CTAs: the most, up to :data:`MAX_CLUSTER`, whose clusters for the whole
batch can all run at once on the card.  That count comes from the card
(``cudaOccupancyMaxActiveClusters`` for each size, through the C entry
``tpuslam_thomas_clusters``), not from the SM count alone: an H100's
clusters sit within its GPCs, so at M = 120 it holds 30 clusters of 4
CTAs, not 33, and 32 scenes in clusters of 4 would run in two waves.  One
launch runs the whole chain; ``_build.launches["thomas_factor"]`` counts
it, and its plan (the C entry, the device index and the counts of
resident clusters) is built once a device and M by ``_build.cached``.
:data:`MAX_M`, :data:`PANEL` and :data:`MAX_CLUSTER` are the source's
``kMaxM``, ``kPanel`` and ``kMaxCluster``, which its C entries check
again (a source test holds the two equal).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpuslam_torch.ops import _build

#: K6's largest cluster: the portable limit.
MAX_CLUSTER = 8
#: K6's Cholesky panel: a chain's super-block size M is bordered up to a
#: multiple of it.
PANEL = 8
#: The largest (bordered) M whose shared-memory plan (three ``M x (M +
#: 4)`` float32 buffers and an ``8 x M`` panel) fits a CTA's shared memory
#: on an H100.
MAX_M = 128


def cluster_size(batch: int, resident: tuple) -> int:
    """K6's CTAs a batch matrix: the largest C whose ``batch`` clusters
    all fit at once, ``resident[C - 1]`` being the card's most resident
    clusters of C CTAs; else 1 (the batch then runs in waves)."""
    for c in range(len(resident), 1, -1):
        if batch <= resident[c - 1]:
            return c
    return 1


def fits(diag: torch.Tensor) -> bool:
    """Whether K6 factors a chain ``diag`` (``(N, *B, M, M)``) of this
    shape and dtype: float32, square super-blocks, M bordered up to a
    multiple of :data:`PANEL` at most :data:`MAX_M`."""
    shape = tuple(diag.shape)
    m = shape[-1] if shape else 0
    return (diag.dtype == torch.float32 and len(shape) >= 3
            and shape[-2] == m and 0 < -(-m // PANEL) * PANEL <= MAX_M)


def bordered(diag: torch.Tensor, upper: torch.Tensor, mb: int):
    """``(diag, upper)`` with super-blocks of ``mb >= M``: each diagonal
    block bordered by the identity, each coupling block by zeros.  Its
    factor is the chain's, bordered the same way: the border's Schur
    complements stay the identity and meet the chain's blocks only in
    products with exact zeros, so the chain's blocks of ``invs`` and
    ``ws`` keep their values."""
    m = diag.shape[-1]
    d = diag.new_zeros((*diag.shape[:-2], mb, mb))
    d[..., :m, :m] = diag
    d[..., m:, m:].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    u = upper.new_zeros((*upper.shape[:-2], mb, mb))
    u[..., :m, :m] = upper
    return d, u


def _resident(lib, device: torch.device, m: int) -> tuple:
    """The card's most resident clusters of 1 .. :data:`MAX_CLUSTER` CTAs
    at super-block size ``m``."""
    counts = (ctypes.c_int * MAX_CLUSTER)()
    rc = _build._on_device(lib.tpuslam_thomas_clusters, device.index,
                           (m, counts))
    if rc != 0:
        raise RuntimeError(f"tpuslam_thomas_clusters failed: CUDA error {rc}")
    return tuple(counts)


def _plan(device: torch.device, m: int):
    """``(entry, device index, resident clusters by size)``, built once a
    device and super-block size."""
    def build():
        lib = _build.cuda_library(device)
        return lib.tpuslam_thomas_factor, device.index, _resident(lib, device,
                                                                  m)
    return _build.cached(("thomas_factor", device, m), build)


def _check(diag: torch.Tensor, upper: torch.Tensor) -> None:
    if diag.ndim < 3:
        raise ValueError(f"diag must be (N, *B, M, M), got shape "
                         f"{tuple(diag.shape)}")
    n, m = diag.shape[0], diag.shape[-1]
    batch = tuple(diag.shape[1:-2])
    _build.check_tensor("diag", diag, (n, *batch, m, m), torch.float32,
                        diag.device)
    _build.check_tensor("upper", upper, (n - 1, *batch, m, m), torch.float32,
                        diag.device)
    if not fits(diag):
        raise ValueError(f"diag: super-block size {m} past K6's "
                         f"shared-memory plan (at most {MAX_M})")
    for name, t in (("diag", diag), ("upper", upper)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(diag: torch.Tensor, upper: torch.Tensor):
    """K6's launch on checked tensors: ``(invs, ws)``, the chain bordered
    up to a multiple of :data:`PANEL` for the launch where it is not one,
    and cut back after it."""
    n, m = diag.shape[0], diag.shape[-1]
    mb = -(-m // PANEL) * PANEL
    if mb != m:
        diag, upper = bordered(diag, upper, mb)
    entry, index, resident = _plan(diag.device, mb)
    batch = math.prod(diag.shape[1:-2])
    invs = torch.empty_like(diag)
    ws = torch.empty_like(diag)
    _build.launch("thomas_factor", entry, index, diag.data_ptr(),
                  upper.data_ptr() if n > 1 else None, invs.data_ptr(),
                  ws.data_ptr(), n, batch, mb, cluster_size(batch, resident))
    if mb != m:
        return (invs[..., :m, :m].contiguous(),
                ws[..., :m, :m].contiguous())
    return invs, ws


def thomas_factor(diag: torch.Tensor, upper: torch.Tensor):
    """K6: the Thomas factor's Schur inverses and multipliers of the
    symmetric block-tridiagonal chain ``diag`` (``(N, *B, M, M)``),
    ``upper`` (``(N-1, *B, M, M)``), both float32, contiguous, on one CUDA
    device; one launch.

    Returns ``(invs, ws)``, each ``(N, *B, M, M)``: the fields of
    :class:`~tpuslam_torch.slam.tridiag.ThomasFactor` that
    :func:`~tpuslam_torch.slam.tridiag.block_thomas_factor_plain` computes
    (its ``up`` is ``upper`` zero-extended).  Where a Schur complement is
    not positive definite, that matrix's ``invs`` are NaN from that step
    on.  Raises ``ValueError`` naming the argument for a wrong device,
    dtype, shape, contiguity or super-block size (:func:`fits`).
    """
    _check(diag, upper)
    if diag.device.type != "cuda":
        raise ValueError(f"diag on {diag.device}: K6 takes CUDA tensors")
    return _launch(diag, upper)
