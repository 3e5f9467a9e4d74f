// The occupancy calculator behind each source's tpuslam_occupancy_* entry
// point: resident blocks per SM of one kernel at its launch shape, with
// the kernel's name for the report (tpuslam_torch/utils/kernel_report.py).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace tpuslam {

template <class Kernel>
int occupancy(Kernel kernel, const char* label, int threads, size_t smem,
              int* blocks, const char** name) {
  *name = label;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem));
}

}  // namespace tpuslam
