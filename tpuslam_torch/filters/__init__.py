"""L2 estimators: the EKF (the particle filter comes in a later slice)."""

from tpuslam_torch.filters.ekf import (EkfConfig, EkfOut, EkfState, ekf_init,
                                       ekf_predict, ekf_rollout,
                                       ekf_rollout_batch, ekf_step,
                                       ekf_step_with_noise, ekf_update)

__all__ = [
    "EkfConfig", "EkfOut", "EkfState", "ekf_init", "ekf_predict",
    "ekf_rollout", "ekf_rollout_batch", "ekf_step", "ekf_step_with_noise",
    "ekf_update",
]
