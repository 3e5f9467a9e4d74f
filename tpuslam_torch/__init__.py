"""tpu-slam-sim's batched EKF-SLAM path in PyTorch, with CUDA kernels.

A port of the JAX package ``tpuslam`` that mirrors its layout and public
names; it imports neither JAX nor ``tpuslam``.

Layer map:
    core/      angle wrap, SE(2) transforms, matmul precision
    models/    circular process model, observations
    filters/   the EKF as plain functions on tensors
    metrics/   RMSE / NEES / divergence masks
    ops/       CUDA kernels (csrc/) beside their plain torch versions
    utils/     timing on the card
    convert    configs and state across from the JAX package
    entry      the single-call entry point
"""

__version__ = "0.1.0"

from tpuslam_torch import core, filters, metrics, models, ops

__all__ = ["core", "filters", "metrics", "models", "ops", "__version__"]
