"""L1 physical models: circular process model, observations, the
velocity motion model and the landmark scan sensor."""

from tpuslam_torch.models.motion import (MotionConfig, motion_mean,
                                         motion_sample,
                                         motion_sample_with_noise,
                                         noise_sigmas)
from tpuslam_torch.models.observation import (landmark_observation,
                                              position_observation)
from tpuslam_torch.models.process import circular_jacobian, circular_step
from tpuslam_torch.models.scan_sensor import (Scan, ScanConfig,
                                              cov_measurement_to_robot,
                                              cov_measurement_to_world,
                                              measurement_cov, scan,
                                              scan_apply_noise, scan_true)

__all__ = [
    "MotionConfig",
    "motion_mean",
    "motion_sample",
    "motion_sample_with_noise",
    "noise_sigmas",
    "landmark_observation",
    "position_observation",
    "circular_jacobian",
    "circular_step",
    "Scan",
    "ScanConfig",
    "cov_measurement_to_robot",
    "cov_measurement_to_world",
    "measurement_cov",
    "scan",
    "scan_apply_noise",
    "scan_true",
]
