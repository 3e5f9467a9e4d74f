"""Dense graph SLAM: batched edge construction, information-matrix
assembly, Gauss-Newton solving, and the simulation frontend."""

from tpuslam_torch.slam.frontend import (REF_SLAM_LANDMARKS, SlamSceneConfig,
                                         SlamTrajectory, estimate_frames,
                                         observed_times_mask,
                                         reference_course_config, simulate,
                                         simulate_with_noise, slam_rollout,
                                         solve_once)
from tpuslam_torch.slam.graph import (GraphConfig, GraphObservations,
                                      GraphSolveResult, assemble, build_edges,
                                      gn_iteration, graph_solve, kept_times,
                                      preconditioned_solve, upper_pairs)

__all__ = [
    "REF_SLAM_LANDMARKS", "SlamSceneConfig", "SlamTrajectory",
    "estimate_frames", "observed_times_mask", "reference_course_config",
    "simulate", "simulate_with_noise", "slam_rollout", "solve_once",
    "GraphConfig", "GraphObservations", "GraphSolveResult", "assemble",
    "build_edges", "gn_iteration", "graph_solve", "kept_times",
    "preconditioned_solve", "upper_pairs",
]
