"""Chi-squared (2 dof) inverse CDF for confidence ellipses, on tensors.

Port of ``tpuslam/core/chi2.py`` (reference: ``mylib/error_ellipse.py:24-37``,
a 43-entry table of chi-squared values interpolated linearly against
confidence percentages).

  * :func:`chi2_ppf_2dof_table` - linear interpolation over the same
    43-point grid.
  * :func:`chi2_ppf_2dof` - the closed form ``x = -2 ln(1 - p/100)``
    (the 2-dof CDF is ``1 - exp(-x/2)``).
"""

from __future__ import annotations

import math

import torch

#: Confidence percentages of the reference table (descending).
P_GRID = (99.9, 99.5, 99.0, 98.5, 98.0, 97.5, 97.0, 96.0, 95.0, 94.0, 93.0,
          92.0, 91.0, 90.0, 85.0, 80.0, 75.0, 70.0, 65.0, 60.0, 55.0, 50.0,
          45.0, 40.0, 35.0, 30.0, 25.0, 20.0, 15.0, 10.0, 9.0, 8.0, 7.0,
          6.0, 5.0, 4.0, 3.0, 2.5, 2.0, 1.5, 1.0, 0.5, 0.0)

#: The chi-squared (2 dof) quantiles of :data:`P_GRID`, computed once at
#: import in float64.
CHI2_GRID = tuple(-2.0 * math.log1p(-p / 100.0) for p in P_GRID)


def _as_float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def chi2_ppf_2dof(p_percent) -> torch.Tensor:
    """Exact chi-squared (2 dof) quantile for p% central confidence."""
    return -2.0 * torch.log1p(-_as_float(p_percent) / 100.0)


def chi2_ppf_2dof_table(p_percent) -> torch.Tensor:
    """Table-interpolated quantile over the reference's 43-point grid.

    ``jnp.interp``'s piecewise-linear lookup over the ascending grid:
    the segment from a right-sided search, clamped to the end values
    outside the grid.
    """
    x = _as_float(p_percent)
    xp = torch.tensor(P_GRID[::-1], dtype=x.dtype, device=x.device)
    fp = torch.tensor(CHI2_GRID[::-1], dtype=x.dtype, device=x.device)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, len(P_GRID) - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
