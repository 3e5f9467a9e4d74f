"""Hand-written CUDA kernels for the hot paths, each beside its plain
torch version."""

from tpuslam_torch.ops.ekf_cuda import (ekf_fused_rollout,
                                        ekf_fused_rollout_plain,
                                        ekf_fused_sweeps)
from tpuslam_torch.ops.pf_batch_cuda import (PfBatchOut, PfBatchState,
                                             PfBatchWideState, pf_batch_init,
                                             pf_batch_refresh_stats,
                                             pf_batch_rollout, pf_batch_step,
                                             pf_batch_wide_init,
                                             pf_batch_wide_rollout,
                                             pf_batch_wide_step)
from tpuslam_torch.ops.pf_cuda import (PfFusedState, pf_fused_init,
                                       pf_fused_predict_weight,
                                       pf_fused_predict_weight_plain,
                                       pf_fused_predict_weight_stats,
                                       pf_fused_predict_weight_stats_plain,
                                       pf_fused_rollout,
                                       pf_fused_rollout_plain, pf_fused_step,
                                       pf_fused_step_stats,
                                       pf_fused_step_stats_plain,
                                       pf_fused_to_state)
from tpuslam_torch.ops.resample_cuda import (compact_particles,
                                             compact_particles_seg,
                                             expand_compressed,
                                             expand_compressed_seg,
                                             merge_options,
                                             merge_resample_rows,
                                             merge_resample_rows_plain)

__all__ = ["ekf_fused_rollout", "ekf_fused_rollout_plain",
           "ekf_fused_sweeps",
           "pf_fused_predict_weight", "pf_fused_predict_weight_plain",
           "pf_fused_predict_weight_stats",
           "pf_fused_predict_weight_stats_plain", "PfFusedState",
           "pf_fused_init", "pf_fused_to_state", "pf_fused_step",
           "pf_fused_step_stats", "pf_fused_step_stats_plain",
           "pf_fused_rollout", "pf_fused_rollout_plain",
           "merge_resample_rows", "merge_resample_rows_plain",
           "merge_options", "compact_particles", "compact_particles_seg",
           "expand_compressed", "expand_compressed_seg",
           "PfBatchState", "PfBatchOut", "PfBatchWideState", "pf_batch_init",
           "pf_batch_refresh_stats", "pf_batch_step", "pf_batch_rollout",
           "pf_batch_wide_init", "pf_batch_wide_step",
           "pf_batch_wide_rollout"]
