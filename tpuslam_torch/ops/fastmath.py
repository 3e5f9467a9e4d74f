"""Polynomial sincos, Box-Muller and Philox in plain torch.

Port of ``tpuslam/ops/fastmath.py`` and the plain twins of the device
functions in ``csrc/fastmath.cuh``, which the EKF kernel inlines:

* :func:`sincos_turns` / :func:`sincos_rad` - quadrant fold plus
  quarter-turn polynomials, both values from one fold (max f32 error
  about 1.8e-7).
* :func:`normals_from_bits` - Box-Muller from two words of random bits,
  with the JAX package's bit-to-uniform map: the 24 high bits, and
  ``u1`` shifted by half an ulp so that it is never 0.
* :func:`philox4x32` - the Philox4x32-10 counter-based generator
  (Salmon et al., SC'11) on int64 tensors holding 32-bit words.  It gives
  the kernel's random bits bit for bit, so the plain EKF rollout draws
  the kernel's noise stream; :func:`philox_round_keys` is its key
  schedule, which the EKF kernel's C entry folds the same way.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi
_MASK32 = 0xFFFFFFFF

# sin(h) = h * P(h^2), cos(h) = Q(h^2) on h in [0, pi/2); the JAX
# package's coefficients, fit on Chebyshev nodes.
_SIN_C = (0.9999999812130134, -0.16666649688716711,
          0.008332926736968374, -0.00019802254676520736,
          2.592816210455618e-06)
_COS_C = (0.9999999999054029, -0.4999999950367743,
          0.04166664009947133, -0.0013888400245756864,
          2.476182880839003e-05, -2.607709311324439e-07)

# Philox4x32 multipliers and Weyl key increments.
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_PHILOX_ROUNDS = 10


def sincos_turns(u: torch.Tensor):
    """``(cos, sin)`` of ``2*pi*u`` for ``u`` in ``[0, 1)``."""
    t = u * 4.0
    q = torch.floor(t)
    h = (t - q) * (math.pi / 2.0)
    h2 = h * h
    sp = _SIN_C[-1]
    for c in _SIN_C[-2::-1]:
        sp = sp * h2 + c
    sp = h * sp
    cp = _COS_C[-1]
    for c in _COS_C[-2::-1]:
        cp = cp * h2 + c
    q1 = q == 1.0
    q2 = q == 2.0
    q3 = q == 3.0
    cos_v = torch.where(q1, -sp, torch.where(q2, -cp,
                                             torch.where(q3, sp, cp)))
    sin_v = torch.where(q1, cp, torch.where(q2, -sp,
                                            torch.where(q3, -cp, sp)))
    return cos_v, sin_v


def sincos_rad(theta: torch.Tensor):
    """``(cos, sin)`` of an angle in radians of any magnitude."""
    u = theta * (1.0 / _TWO_PI)
    u = u - torch.floor(u)
    return sincos_turns(u)


def normals_from_bits(b1: torch.Tensor, b2: torch.Tensor):
    """One Box-Muller pair ``(r cos, r sin)`` of float32 standard normals
    from two integer tensors of random 32-bit words (any int dtype; the
    low 32 bits are used)."""
    hi1 = (b1.to(torch.int64) & _MASK32) >> 8
    hi2 = (b2.to(torch.int64) & _MASK32) >> 8
    u1 = (hi1.to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    u2 = hi2.to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = sincos_turns(u2)
    return r * c, r * s


def _mulhilo(a, m: int):
    """High and low 32-bit words of ``a * m`` for 32-bit ``a`` and ``m``.

    ``m`` is split into 16-bit halves so that no int64 product
    overflows.
    """
    m_hi, m_lo = m >> 16, m & 0xFFFF
    p_hi = a * m_hi
    p_lo = a * m_lo
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox_round_keys(k0: int, k1: int) -> tuple[list[int], list[int]]:
    """The round keys of each key word, ``k0 + r * W0`` and
    ``k1 + r * W1`` modulo ``2**32`` for the ten rounds: the schedule
    :func:`philox4x32` computes round by round, as a kernel whose key is
    the same for every thread takes it, folded once."""
    return ([(k0 + r * _PHILOX_W0) & _MASK32 for r in range(_PHILOX_ROUNDS)],
            [(k1 + r * _PHILOX_W1) & _MASK32 for r in range(_PHILOX_ROUNDS)])


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter ``(c0, c1, c2, c3)`` under the key
    ``(k0, k1)``.

    Counter words are int64 tensors (or Python ints) holding values in
    ``[0, 2**32)``; tensors broadcast.  Returns the four output words in
    the same form.
    """
    for r in range(_PHILOX_ROUNDS):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
