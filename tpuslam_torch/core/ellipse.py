"""Confidence error-ellipse parameters from a 2x2 covariance, batched.

Port of ``tpuslam/core/ellipse.py`` (reference:
``mylib/error_ellipse.py:39-68``): eigendecompose the covariance, scale
the axes by the chi-squared quantile, report the major axis's angle.

``row_eigvec_compat=True`` (default) keeps the reference's quirk of
reading a *row* of the eigenvector matrix (``vec[idxmax]``,
mylib/error_ellipse.py:51) instead of the column eigenvector.
Eigenvector signs differ between LAPACK and cuSOLVER, so an angle is
defined modulo pi.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.chi2 import chi2_ppf_2dof_table


def error_ellipse(sigma, p_percent=99.0, row_eigvec_compat=True):
    """``(major, minor, angle_rad)`` of the p% error ellipse of
    ``(..., 2, 2)`` covariances, each of shape ``(...)``.  Axis length
    = 2 sqrt(lambda chi2)."""
    sigma = torch.as_tensor(sigma)
    chi2 = chi2_ppf_2dof_table(torch.as_tensor(
        p_percent, dtype=sigma.dtype, device=sigma.device))
    val, vec = torch.linalg.eigh(sigma)  # ascending eigenvalues
    vmax = val[..., 1]
    vmin = val[..., 0]
    if row_eigvec_compat:
        vecmax = vec[..., 1, :]
    else:
        vecmax = vec[..., :, 1]
    ang = torch.atan2(vecmax[..., 1], vecmax[..., 0])
    major = 2.0 * torch.sqrt(vmax * chi2)
    minor = 2.0 * torch.sqrt(vmin * chi2)
    return major, minor, ang


def major_axis_length(sigma, p_percent):
    """Major-axis length only (reference: mylib/error_ellipse.py:57-68)."""
    major, _, _ = error_ellipse(sigma, p_percent)
    return major
