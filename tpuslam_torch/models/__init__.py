"""L1 physical models: circular process model and observations."""

from tpuslam_torch.models.observation import (landmark_observation,
                                              position_observation)
from tpuslam_torch.models.process import circular_jacobian, circular_step

__all__ = [
    "landmark_observation",
    "position_observation",
    "circular_jacobian",
    "circular_step",
]
