"""Angle wrapping on tensors.

Port of ``tpuslam/core/angles.py``: the reference's scalar
``limit_angle`` loop (mylib/limit.py:11-26) in closed form.  For a
magnitude m = |a| the loop subtracts 2*pi exactly
k = max(0, ceil((m - pi) / (2*pi))) times, then restores the sign.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to the reference's ``limit_angle`` range.

    Exact functional equivalent of the reference loop for every float
    input, any shape.
    """
    a = torch.as_tensor(angle)
    mag = a.abs()
    k = torch.clamp(torch.ceil((mag - math.pi) / TWO_PI), min=0.0)
    wrapped = mag - TWO_PI * k
    return torch.where(a < 0, -wrapped, wrapped)


def wrap_angle_fast(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] via atan2.

    Differs from :func:`wrap_angle` only at exact odd multiples of pi
    (a set of measure zero) and by float rounding elsewhere.
    """
    a = torch.as_tensor(angle)
    return torch.atan2(torch.sin(a), torch.cos(a))
