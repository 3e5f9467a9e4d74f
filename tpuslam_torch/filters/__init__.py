"""L2 estimators: the EKF and the particle filter."""

from tpuslam_torch.filters.ekf import (EkfConfig, EkfOut, EkfState, ekf_init,
                                       ekf_predict, ekf_rollout,
                                       ekf_rollout_batch, ekf_step,
                                       ekf_step_with_noise, ekf_update)
from tpuslam_torch.filters.pf import (PfConfig, PfOut, PfState,
                                      bivariate_normal_pdf,
                                      effective_sample_size, pf_estimate,
                                      pf_init, pf_likelihood, pf_rollout,
                                      pf_rollout_batch, pf_step,
                                      pf_step_with_noise,
                                      resample_indices_from_offs,
                                      systematic_resample)

__all__ = [
    "EkfConfig", "EkfOut", "EkfState", "ekf_init", "ekf_predict",
    "ekf_rollout", "ekf_rollout_batch", "ekf_step", "ekf_step_with_noise",
    "ekf_update",
    "PfConfig", "PfOut", "PfState", "bivariate_normal_pdf",
    "effective_sample_size", "pf_estimate", "pf_init", "pf_likelihood",
    "pf_rollout", "pf_rollout_batch", "pf_step", "pf_step_with_noise",
    "resample_indices_from_offs", "systematic_resample",
]
