"""Call keys from the seed, and percentiles."""

from __future__ import annotations

import random
import statistics

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def call_key(seed: int, i: int, tag: int = 0) -> int:
    """The 63-bit key of call ``i`` of a run under ``seed`` (``tag``
    separates the warm-up and the check's draws from the window's calls).
    Any integer seed, of any size or sign, gives a key."""
    x = _splitmix64(seed & _MASK64)
    x = _splitmix64(x ^ (i & _MASK64))
    return _splitmix64(x ^ tag) >> 1


def rng(seed: int, i: int, tag: int) -> random.Random:
    """A host random stream for the check's draws, keyed like a call."""
    return random.Random(call_key(seed, i, tag))


def percentile(values: list[float], q: int) -> float:
    """The ``q``-th percentile (``0 < q < 100``) of all values, interpolated
    between the closest ranks (numpy's default)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
