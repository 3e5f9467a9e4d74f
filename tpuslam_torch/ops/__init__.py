"""Hand-written CUDA kernels for the hot paths, each beside its plain
torch version."""

from tpuslam_torch.ops.ekf_cuda import (ekf_fused_rollout,
                                        ekf_fused_rollout_plain,
                                        ekf_fused_sweeps)

__all__ = ["ekf_fused_rollout", "ekf_fused_rollout_plain",
           "ekf_fused_sweeps"]
