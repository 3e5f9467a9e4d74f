"""Metrics: RMSE, NEES, divergence masks."""

from tpuslam_torch.metrics.metrics import (divergence_mask, nees,
                                           nees_consistency, position_rmse,
                                           summarize_rollouts, yaw_rmse)

__all__ = ["divergence_mask", "nees", "nees_consistency", "position_rmse",
           "summarize_rollouts", "yaw_rmse"]
