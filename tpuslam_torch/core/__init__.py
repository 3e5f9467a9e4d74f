"""L0 math: angle wrap, SE(2) transforms, matmul precision."""

from tpuslam_torch.core.angles import wrap_angle, wrap_angle_fast
from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.core.se2 import BASE_ANG, robot_to_world, world_to_robot

__all__ = [
    "wrap_angle",
    "wrap_angle_fast",
    "highest_matmul_precision",
    "BASE_ANG",
    "robot_to_world",
    "world_to_robot",
]
