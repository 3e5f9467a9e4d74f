"""What the two PF drivers share: the scene as the program's config
fields, the weighted cloud mean, and the comparison's numbers."""

from __future__ import annotations

import torch

from benchlib.check import largest
from reference.ekf import wrap


def pf_fields(scene: dict) -> dict:
    """The scene's keys as the program's ``PfConfig`` fields (tuples)."""
    return {k: tuple(map(tuple, v)) if k == "landmarks" else
            tuple(v) if isinstance(v, list) else v for k, v in scene.items()}


def cloud_mean(particles: torch.Tensor, weights: torch.Tensor):
    """``(..., 3)`` weighted mean of ``(..., n, 3)`` particles: x, y and the
    circular mean of yaw."""
    w = weights.to(torch.float64)
    p = particles.to(torch.float64)
    w = w / w.sum(dim=-1, keepdim=True)
    xy = (w[..., None] * p[..., :2]).sum(dim=-2)
    yaw = torch.atan2((w * torch.sin(p[..., 2])).sum(dim=-1),
                      (w * torch.cos(p[..., 2])).sum(dim=-1))
    return torch.cat([xy, yaw[..., None]], dim=-1)


def gaps(got: dict, want: dict) -> dict:
    """The PF comparison of the program's (got) and the reference's (want)
    ``x_est (T, F, 3)`` estimates and ``mean (F, 3)`` final cloud means,
    against the reference's truth ``x_true (T, 3)``.

    Once a resample takes another particle than the reference's (a
    rounding apart), the two clouds are independent draws of one
    posterior, so one filter's MAP estimate jitters between them.  Means
    over filters and steps do not: ``*_bias_m`` average the gaps over the
    filters, ``rmse_gap_rel`` compares the estimates' RMSE against the
    truth over every filter and step.  The ``*_gap_*`` maxima catch gross
    faults.
    """
    d = (got["x_est"] - want["x_est"]).to(torch.float64)
    dm = (got["mean"] - want["mean"]).to(torch.float64)
    truth = want["x_true"].to(torch.float64)[:, None, :2]

    def rmse(est):
        e = est[..., :2].to(torch.float64) - truth
        return e.square().sum(dim=-1).mean().sqrt()

    r_got, r_want = rmse(got["x_est"]), rmse(want["x_est"])
    return {
        "est_gap_m": largest(torch.linalg.vector_norm(d[..., :2], dim=-1)),
        "est_yaw_gap_rad": largest(wrap(d[..., 2]).abs()),
        "est_bias_m": largest(d[..., :2].mean(dim=1).square().sum(dim=-1)
                              .mean().sqrt()),
        "mean_gap_m": largest(torch.linalg.vector_norm(dm[..., :2], dim=-1)),
        "mean_bias_m": largest(torch.linalg.vector_norm(
            dm[..., :2].mean(dim=0))),
        "rmse_gap_rel": largest((r_got - r_want).abs() / r_want)}
