"""L0 math: angle wrap, SE(2) transforms, matmul precision, chi-squared
quantiles, error ellipses and the shared PCG routine."""

from tpuslam_torch.core.angles import wrap_angle, wrap_angle_fast
from tpuslam_torch.core.chi2 import chi2_ppf_2dof, chi2_ppf_2dof_table
from tpuslam_torch.core.ellipse import error_ellipse, major_axis_length
from tpuslam_torch.core.pcg import pcg
from tpuslam_torch.core.precision import highest_matmul_precision
from tpuslam_torch.core.se2 import BASE_ANG, robot_to_world, world_to_robot

__all__ = [
    "wrap_angle",
    "wrap_angle_fast",
    "chi2_ppf_2dof",
    "chi2_ppf_2dof_table",
    "error_ellipse",
    "major_axis_length",
    "pcg",
    "highest_matmul_precision",
    "BASE_ANG",
    "robot_to_world",
    "world_to_robot",
]
