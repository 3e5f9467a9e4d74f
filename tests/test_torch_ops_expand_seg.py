"""The segmented K3b's twin at the shapes ``chip_smoke.py`` holds the
windowed kernel to on the card, on the CPU.

The kernel (``csrc/resample.cu::expand_seg_kernel``) cuts each firing
slot's row into windows of boundaries, one block a window; it runs only
on a card, where it is held to :func:`resample_expand_seg_plain` bit for
bit.  Here that twin is held, slot by slot, to the single-filter twin
:func:`resample_expand_plain` (itself held to the JAX package's ``hist``
decode in ``tests/test_torch_ops_resample.py``) at the same kinds of
shapes: one survivor a filter, ragged rows, rows longer than a window,
idle slots between firing ones.  The inputs are ``chip_smoke.py``'s
(:func:`tpuslam_torch.utils.turns.seg_args`).  Exact equality throughout.
"""

import pytest
import torch

from tpuslam_torch.ops import resample_cuda as rs
from tpuslam_torch.utils.turns import seg_args


# Each under torch's 32,768-element grain (three planes of b x n).
@pytest.mark.parametrize("b,n,one_survivor", [
    (3, 3000, False),   # two 2048-boundary windows, the last short
    (3, 2049, True),    # one particle takes every slot
    (2, 5001, False),   # three windows, rows not 16-byte aligned
])
def test_segmented_twin_is_the_single_filter_twin_a_slot(rng, b, n,
                                                         one_survivor):
    n_fire = b - 1  # filter 1 idle, between firing filters where b = 3
    p, t_hi, fids, valid = seg_args("cpu", b, n, n_fire,
                                    int(rng.integers(1 << 30)), one_survivor)
    out = rs.resample_expand_seg(p, t_hi, fids, valid)
    assert int(valid.sum()) == n_fire
    for s in range(b):
        if not valid[s]:
            assert not out[:, s].any()
            continue
        want = rs.resample_expand_plain(p[:, int(fids[s])], t_hi[s], n)
        assert torch.equal(out[:, s], want)
    if one_survivor:
        v = out[:, valid]
        assert torch.equal(v, v[:, :, :1].expand_as(v))
