"""Graph SLAM: the dense path (batched edge construction, information-
matrix assembly, Gauss-Newton solving, the simulation frontend) and the
large-scale banded path (windowed edges, flat banded assembly, and its
solvers: PCG, the super-block Thomas chain, cyclic reduction and the
banded Cholesky)."""

from tpuslam_torch.slam.frontend import (REF_SLAM_LANDMARKS, SlamSceneConfig,
                                         SlamTrajectory, estimate_frames,
                                         observed_times_mask,
                                         reference_course_config, simulate,
                                         simulate_with_noise, slam_rollout,
                                         solve_once)
from tpuslam_torch.slam.cyclic import banded_solve_cr, block_cr_solve
from tpuslam_torch.slam.graph import (GraphConfig, GraphObservations,
                                      GraphSolveResult, assemble, build_edges,
                                      gn_iteration, graph_solve, kept_times,
                                      preconditioned_solve, upper_pairs)
from tpuslam_torch.slam.large import (BandedSolveResult, EdgeList,
                                      add_odometry_chain, assemble_banded,
                                      banded_matvec, build_edge_blocks,
                                      cg_solve, count_window_pairs,
                                      graph_solve_banded, make_large_scene,
                                      make_large_scene_with_noise,
                                      window_pairs, window_pairs_device)

__all__ = [
    "REF_SLAM_LANDMARKS", "SlamSceneConfig", "SlamTrajectory",
    "estimate_frames", "observed_times_mask", "reference_course_config",
    "simulate", "simulate_with_noise", "slam_rollout", "solve_once",
    "GraphConfig", "GraphObservations", "GraphSolveResult", "assemble",
    "build_edges", "gn_iteration", "graph_solve", "kept_times",
    "preconditioned_solve", "upper_pairs", "BandedSolveResult",
    "EdgeList", "add_odometry_chain", "assemble_banded", "banded_matvec",
    "build_edge_blocks", "cg_solve", "count_window_pairs",
    "graph_solve_banded", "make_large_scene", "make_large_scene_with_noise",
    "window_pairs", "window_pairs_device", "banded_solve_cr",
    "block_cr_solve",
]
