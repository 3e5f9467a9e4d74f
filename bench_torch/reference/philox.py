"""Philox4x32-10 and the Box-Muller map from its words to normals, in plain
torch, for the benchmark's references.

Philox4x32-10 is Salmon et al., "Parallel random numbers: as easy as 1, 2,
3" (SC'11): ten rounds of two 32x32->64 products, the key bumped by the
Weyl constants between rounds.  Words live in int64 tensors holding values
in ``[0, 2**32)``.

The program under test documents its map from words to normals: the 24
high bits of a word, the first uniform shifted by half a step so it is
never 0, and ``(r cos 2 pi u2, r sin 2 pi u2)`` with
``r = sqrt(-2 log u1)``.  :func:`box_muller` computes it with torch's own
transcendentals in the caller's dtype.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mul_wide(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit words of the 64-bit product ``a * m``."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    lo_lo = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi  # < 2**33: no int64 overflow
    lo = (lo_lo + ((mid & 0xFFFF) << 16)) & MASK32
    carry = (lo_lo + ((mid & 0xFFFF) << 16)) >> 32
    hi = (a_hi * m_hi + (mid >> 16) + carry) & MASK32
    return hi, lo


def philox(c0, c1, c2, c3, key: int):
    """The four output words of the counter ``(c0, c1, c2, c3)`` under the
    64-bit ``key`` (low word first).  Counter words are int64 tensors or
    ints; they broadcast."""
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    like = next(c for c in (c0, c1, c2, c3) if torch.is_tensor(c))
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64,
                                      device=like.device)
                      for c in (c0, c1, c2, c3))
    for r in range(10):
        hi0, lo0 = _mul_wide(c0, _M0)
        hi1, lo1 = _mul_wide(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def unit(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A word's 24 high bits as a uniform in ``[0, 1)``."""
    return (word >> 8).to(torch.float64).div(1 << 24).to(dtype)


def box_muller(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype):
    """One pair of standard normals from two words, in ``dtype``."""
    u1 = ((w1 >> 8).to(torch.float64) + 0.5).div(1 << 24).to(dtype)
    u2 = unit(w2, dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * u2
    return r * torch.cos(ang), r * torch.sin(ang)
