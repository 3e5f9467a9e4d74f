"""Estimation metrics on tensors: RMSE, NEES, divergence masks.

Port of ``tpuslam/metrics/metrics.py``.  Every function takes arbitrary
leading batch/time axes and reduces on the tensors' device, so a sweep
costs one host transfer, not one per step.
"""

from __future__ import annotations

import torch


def _mean(x: torch.Tensor, axis=None) -> torch.Tensor:
    return x.mean() if axis is None else x.mean(dim=axis)


def position_rmse(est: torch.Tensor, truth: torch.Tensor,
                  axis=None) -> torch.Tensor:
    """Root-mean-square position error over ``axis`` (default: all)."""
    err = est[..., :2] - truth[..., :2]
    se = torch.sum(err * err, dim=-1)
    return torch.sqrt(_mean(se, axis))


def yaw_rmse(est: torch.Tensor, truth: torch.Tensor,
             axis=None) -> torch.Tensor:
    """RMSE of the wrapped yaw error."""
    d = est[..., 2] - truth[..., 2]
    d = torch.atan2(torch.sin(d), torch.cos(d))
    return torch.sqrt(_mean(d * d, axis))


def nees(est: torch.Tensor, truth: torch.Tensor, cov: torch.Tensor,
         dims: int = 2) -> torch.Tensor:
    """Normalized estimation error squared, per step.

    ``dims=2`` uses the position block (chi2 with 2 dof, mean 2 for a
    consistent filter); ``dims=3`` the full pose with the yaw error
    wrapped.
    """
    e = est[..., :dims] - truth[..., :dims]
    if dims == 3:
        d2 = e[..., 2:]
        e = torch.cat([e[..., :2], torch.atan2(torch.sin(d2),
                                               torch.cos(d2))], dim=-1)
    c = cov[..., :dims, :dims]
    sol = torch.linalg.solve(c, e[..., None])[..., 0]
    return torch.sum(e * sol, dim=-1)


def nees_consistency(est: torch.Tensor, truth: torch.Tensor,
                     cov: torch.Tensor, dims: int = 2,
                     axis=None) -> torch.Tensor:
    """Mean NEES over ``axis`` (filter consistency check)."""
    return _mean(nees(est, truth, cov, dims), axis)


def divergence_mask(est: torch.Tensor, truth: torch.Tensor,
                    threshold: float) -> torch.Tensor:
    """``(B,)`` mask, True where a ``(B, T, 3)`` estimate stayed finite
    and within ``threshold`` of the truth for the whole rollout."""
    err = torch.linalg.norm(est[..., :2] - truth[..., :2], dim=-1)
    finite = torch.isfinite(est).flatten(-2).all(dim=-1)
    return finite & (err < threshold).all(dim=-1)


def summarize_rollouts(est: torch.Tensor, truth: torch.Tensor,
                       cov: torch.Tensor | None = None) -> dict:
    """Metrics of ``(B, T, 3)`` rollouts, still on the device: overall,
    yaw and per-rollout RMSE, the divergence mask, and the mean NEES when
    ``cov`` ``(B, T, 3, 3)`` is given."""
    out = {
        "rmse_pos": position_rmse(est, truth),
        "rmse_yaw": yaw_rmse(est, truth),
        "rmse_pos_per_rollout": position_rmse(est, truth, axis=-1),
        "diverged": ~divergence_mask(est, truth, threshold=100.0),
    }
    if cov is not None:
        out["mean_nees"] = nees_consistency(est, truth, cov)
    return out
