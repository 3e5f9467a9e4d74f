"""Matmul-precision control.

On Hopper the hazard is TF32: with it, a float32 product keeps about
three decimal digits, which breaks the linear-algebra recursions of the
filters and solvers.  :func:`highest_matmul_precision` pins full float32
products for the wrapped call only and restores the caller's settings
afterwards, so importing this package changes no global state.
"""

from __future__ import annotations

import functools

import torch


def highest_matmul_precision(fn):
    """Run ``fn`` with TF32 off for matmuls and cuDNN."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev_precision = torch.get_float32_matmul_precision()
        prev_matmul = torch.backends.cuda.matmul.allow_tf32
        prev_cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev_precision)
            torch.backends.cuda.matmul.allow_tf32 = prev_matmul
            torch.backends.cudnn.allow_tf32 = prev_cudnn

    return wrapped
