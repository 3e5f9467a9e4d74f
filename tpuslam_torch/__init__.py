"""tpu-slam-sim's batched EKF, its single-filter, batched and wide
particle filters (with CUDA kernels) and dense graph SLAM, in PyTorch.

A port of the JAX package ``tpuslam`` that mirrors its layout and public
names; it imports neither JAX nor ``tpuslam``.

Layer map:
    core/      angle wrap, SE(2) transforms, matmul precision, chi-squared
               quantiles, error ellipses
    models/    circular process model, observations, velocity motion
               model, landmark scan sensor
    filters/   the EKF and the particle filter as plain functions on tensors
    slam/      dense graph SLAM: edges, H assembly, guarded Gauss-Newton
               (batched over seeds), the simulated reference course
    metrics/   RMSE / NEES / divergence masks
    ops/       CUDA kernels (csrc/) beside their plain torch versions: the
               EKF rollout, the PF step, the merge resample (boundaries,
               expand, and the survivor stack's compaction and compressed
               expand), the batched and wide PF steps
    utils/     timing on the card, host synchronisations
    convert    configs and state across from the JAX package
    entry      the single-call entry point
"""

__version__ = "0.1.0"

from tpuslam_torch import core, filters, metrics, models, ops, slam

__all__ = ["core", "filters", "metrics", "models", "ops", "slam",
           "__version__"]
