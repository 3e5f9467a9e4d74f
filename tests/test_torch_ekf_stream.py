"""K1's Philox noise layout and its bit-preserving arithmetic, on the CPU.

The EKF kernel draws three Philox calls and five Box-Muller transforms
for every two steps: draw 0 of each step gives its four position normals,
and draw 1 of an even step gives one pair, the yaw normals of that step
and of the next (``ops/ekf_cuda.py``'s docstring).  The kernel runs only
on a card, where ``chip_smoke.py`` holds it to its plain twin; here the
twin's stream is rebuilt from :func:`philox4x32` and
:func:`normals_from_bits` directly, the twin is held to the EKF bands, and
a model of the kernel's angle wrap (the divide only where |a| > pi) is held
to both packages' ``wrap_angle`` bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.core.angles as jangles
from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.filters import EkfConfig
from tpuslam_torch.ops import ekf_cuda, ekf_fused_rollout
from tpuslam_torch.ops.fastmath import (normals_from_bits, philox4x32,
                                        philox_round_keys)

CFG = EkfConfig()
SEED = (0x1234ABCD << 32) | 0x9E37  # both key words in play


def _draw(batch: int, k: int, draw: int):
    """The two Box-Muller pairs of Philox call ``draw`` at step ``k``."""
    idx = torch.arange(batch, dtype=torch.int64)
    w = philox4x32(idx, k, draw, 0, SEED & 0xFFFFFFFF, SEED >> 32)
    return normals_from_bits(w[0], w[1]), normals_from_bits(w[2], w[3])


def test_position_normals_are_draw_zero():
    """Every step's n0..n3 are the two pairs of its draw 0."""
    normals = ekf_cuda.philox_normals(SEED, 6, 5, device="cpu")
    assert normals.shape == (5, 5, 6) and normals.dtype == torch.float32
    for k in range(5):
        (n0, n1), (n2, n3) = _draw(6, k, 0)
        assert torch.equal(normals[k, :4], torch.stack([n0, n1, n2, n3]))


def test_even_step_yaw_normal_is_first_of_its_pair():
    """An even step's n4 is the first normal of its draw 1, the value the
    stream gave before draw 1 moved to even steps only."""
    normals = ekf_cuda.philox_normals(SEED, 6, 6, device="cpu")
    for k in (0, 2, 4):
        (first, _), _ = _draw(6, k, 1)
        assert torch.equal(normals[k, 4], first)


def test_odd_step_yaw_normal_is_second_of_the_pair_before():
    """Odd step k+1's n4 is the second Box-Muller output of
    ``philox4x32(i, k, 1, 0)``, which the earlier layout threw away."""
    normals = ekf_cuda.philox_normals(SEED, 6, 6, device="cpu")
    for k in (0, 2, 4):
        (_, second), _ = _draw(6, k, 1)
        assert torch.equal(normals[k + 1, 4], second)
        assert not torch.equal(normals[k + 1, 4], normals[k, 4])


def test_odd_step_count_leaves_the_last_second_normal_unused():
    """With an odd ``n_steps`` the stream is the first steps of a longer
    one, and the rollout runs to finite values of the right shapes."""
    odd = ekf_cuda.philox_normals(SEED, 6, 7, device="cpu")
    assert torch.equal(odd, ekf_cuda.philox_normals(SEED, 6, 8,
                                                    device="cpu")[:7])
    final, err, nees = ekf_fused_rollout(CFG, SEED, 6, 7, with_nees=True,
                                         device="cpu")
    assert final.x_hat.shape == (6, 3) and final.cov.shape == (6, 3, 3)
    assert bool(final.cov.isfinite().all() & err.isfinite().all()
                & nees.isfinite().all())


@pytest.mark.parametrize("n_steps", [1, 6, 7])
def test_philox_rollout_draws_that_stream(n_steps):
    """The Philox rollout equals the rollout fed the stream's normals, bit
    for bit: the twin draws exactly :func:`philox_normals`."""
    kw = dict(with_nees=True, device="cpu")
    philox = ekf_fused_rollout(CFG, SEED, 5, n_steps, **kw)
    fed = ekf_fused_rollout(CFG, SEED, 5, n_steps, normals=ekf_cuda
                            .philox_normals(SEED, 5, n_steps, device="cpu"),
                            **kw)
    for a, b in zip((*philox[0], *philox[1:]), (*fed[0], *fed[1:])):
        assert torch.equal(a, b)


def test_round_keys_are_philox_schedule():
    """The round keys the kernel reads equal the schedule
    :func:`philox4x32` computes: one round of each, by hand."""
    k0, k1 = SEED & 0xFFFFFFFF, SEED >> 32
    rk0, rk1 = philox_round_keys(k0, k1)
    assert len(rk0) == len(rk1) == 10 and (rk0[0], rk1[0]) == (k0, k1)
    ctr = [7, 3, 1, 0]
    for r in range(10):
        p0, p1 = 0xD2511F53 * ctr[0], 0xCD9E8D57 * ctr[2]
        ctr = [(p1 >> 32) ^ ctr[1] ^ rk0[r], p1 & 0xFFFFFFFF,
               (p0 >> 32) ^ ctr[3] ^ rk1[r], p0 & 0xFFFFFFFF]
    assert tuple(ctr) == philox4x32(7, 3, 1, 0, k0, k1)


def test_noisy_rollout_in_the_ekf_bands():
    """512 x 400 with the new stream lands in the bands chip_smoke.py holds
    the kernel to at 8192 x 400: RMSE (0.25, 0.50) and NEES (0.7, 2.5)."""
    b, n = 512, 400
    _, err, nees = ekf_fused_rollout(CFG, 12345, b, n, with_nees=True,
                                     device="cpu")
    rmse = float(torch.sqrt(err / n).mean())
    mean_nees = float((nees / n).mean())
    assert 0.25 < rmse < 0.50
    assert 0.7 < mean_nees < 2.5


# --- the kernel's angle wrap --------------------------------------------------

_PI = np.float32(math.pi)
_TWO_PI = np.float32(2 * math.pi)


def _wrap_fast_model(a: np.ndarray) -> np.ndarray:
    """``csrc/fastmath.cuh::wrap_angle`` in float32: w = |a| where
    |a| <= pi, else the closed form; the sign by the same select."""
    mag = np.abs(a)
    w = mag.copy()
    slow = mag > _PI
    k = np.maximum(np.ceil((mag[slow] - _PI) / _TWO_PI), np.float32(0))
    w[slow] = mag[slow] - _TWO_PI * k
    return np.where(a < 0, -w, w)


def _edges() -> np.ndarray:
    """+-0.0, and +-v, +-v +- 1 ulp for pi, 2 pi, 3 pi, 1 and 1e30 (no
    subnormal: the CPU ops may flush those, the kernel does not)."""
    out = [np.float32(0.0), np.float32(-0.0)]
    for v in np.asarray([_PI, _TWO_PI, 3 * _PI, 1.0, 1e30], np.float32):
        for w in (v, np.nextafter(v, np.float32(np.inf)),
                  np.nextafter(v, np.float32(0))):
            out += [w, -w]
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("which", ["edges", "grid"])
def test_wrap_fast_path_matches_wrap_angle_bit_for_bit(which, rng):
    """On +-0.0, +-pi, +-pi +- 1 ulp, +-3 pi and a random grid the fast
    path equals the closed form of both packages, bit for bit, -0.0 going
    to +0.0 as before."""
    a = (_edges() if which == "edges" else
         rng.uniform(-40.0, 40.0, 20001).astype(np.float32))
    got = _wrap_fast_model(a)
    want = wrap_angle(torch.from_numpy(a)).numpy()
    jwant = np.asarray(jangles.wrap_angle(jnp.asarray(a)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got.view(np.int32), jwant.view(np.int32))
    zero = _wrap_fast_model(np.asarray([-0.0], np.float32))
    assert zero.view(np.int32)[0] == 0
