// Row access and block scans shared by the particle-filter kernels: K2
// (pf_step.cu), K4 (pf_batch.cu) and K5 (pf_wide.cu).
//
// load4/store4 read and write four consecutive lanes of a row, as one
// 16-byte access where the caller has checked `vec` (n % 4 == 0 and the
// row's base 16-byte aligned, pf_math.cuh::aligned16), else as four
// masked scalars.  block_exclusive_scan is the exact int32 scan K4 and K5a
// build their quantized prefixes with.
#pragma once

#include <cuda_runtime.h>

#include "pf_math.cuh"

namespace tpuslam {

// Four consecutive values from j on (zeros past n).
template <class V4, class S>
__device__ __forceinline__ V4 load4_of(const S* p, int j, int n, bool vec) {
  if (vec) {
    return j < n ? *reinterpret_cast<const V4*>(p + j) : V4{0, 0, 0, 0};
  }
  return V4{j < n ? p[j] : S(0), j + 1 < n ? p[j + 1] : S(0),
            j + 2 < n ? p[j + 2] : S(0), j + 3 < n ? p[j + 3] : S(0)};
}

template <class V4, class S>
__device__ __forceinline__ void store4_of(S* p, int j, int n, bool vec,
                                          V4 v) {
  if (vec) {
    if (j < n) *reinterpret_cast<V4*>(p + j) = v;
    return;
  }
  if (j < n) p[j] = v.x;
  if (j + 1 < n) p[j + 1] = v.y;
  if (j + 2 < n) p[j + 2] = v.z;
  if (j + 3 < n) p[j + 3] = v.w;
}

__device__ __forceinline__ float4 load4(const float* p, int j, int n,
                                        bool vec) {
  return load4_of<float4>(p, j, n, vec);
}

__device__ __forceinline__ void store4(float* p, int j, int n, bool vec,
                                       float4 v) {
  store4_of(p, j, n, vec, v);
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Exclusive scan of one int a thread over the block; `total` gets the
// block's sum.  Every warp scans the warp totals itself, so two barriers
// (the second frees s_warp for the next call).  Every thread must call it.
template <int T>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& total) {
  constexpr int kW = T / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int w = lane < kW ? s_warp[lane] : 0;
  w = warp_inclusive_scan(w, lane);
  total = __shfl_sync(kFullMask, w, kW - 1);
  const int before = __shfl_sync(kFullMask, w, warp > 0 ? warp - 1 : 0);
  __syncthreads();
  return (warp > 0 ? before : 0) + incl - v;
}

}  // namespace tpuslam
