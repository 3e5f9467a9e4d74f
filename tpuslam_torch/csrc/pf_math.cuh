// Per-particle device math shared by the particle-filter kernels: K2
// (pf_step.cu), K4 (pf_batch.cu) and K5b (pf_wide.cu).
//
// Device twins of ops/pf_cuda.py::_predict_loglik and the partial-row
// reduction of ops/pf_cuda.py::_partial_plain: the circular predict with
// Q noise, the landmark log-likelihood, the Philox/Box-Muller draw of a
// particle's three normals, and the warp and block reductions behind the
// (max, sum, sum of squares, MAP particle) partial rows.  Moving them here
// changes no operation and no operand order, so each kernel rounds as K2
// did before the move.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fastmath.cuh"

namespace tpuslam {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPartStride = 8;  // floats a partial row

// Noise modes of every PF kernel: off (builtin sinf/cosf, for parity with
// the plain path), Philox, or caller-supplied standard normals.  Modes 1
// and 2 use the polynomial sincos.
constexpr int kNoiseOff = 0;
constexpr int kNoisePhilox = 1;
constexpr int kNoiseNormals = 2;

// Keep (key, idx) of the larger key; on equal keys the larger index.
__device__ __forceinline__ void arg_max(float& key, int& idx, float o_key,
                                        int o_idx) {
  if (o_key > key || (o_key == key && o_idx > idx)) {
    key = o_key;
    idx = o_idx;
  }
}

__device__ __forceinline__ void warp_arg_max(float& key, int& idx) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    arg_max(key, idx, __shfl_down_sync(kFullMask, key, d),
            __shfl_down_sync(kFullMask, idx, d));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFullMask, v, d);
  return v;
}

// Three standard normals of particle `i` of filter `f`: Philox4x32-10
// keyed by the step's seed, counter (i, f, 0, 0), two Box-Muller pairs of
// which the first three values are used.  The single-filter step is
// filter 0.  The stream does not depend on the launch configuration.
__device__ __forceinline__ void philox_normals3(uint32_t i, uint32_t f,
                                                uint32_t key0, uint32_t key1,
                                                float& n0, float& n1,
                                                float& n2) {
  const uint4 r = philox4x32_10(make_uint4(i, f, 0u, 0u),
                                make_uint2(key0, key1));
  const float2 a = normals_from_bits(r.x, r.y);
  const float2 b = normals_from_bits(r.z, r.w);
  n0 = a.x;
  n1 = a.y;
  n2 = b.x;
}

// One particle's predict (particle_filter.py:156-168) and the summed
// log-likelihood of the observation z (n_lm (x, y) pairs in the robot
// frame; particle_filter.py:170-198).  `P` is a kernel's parameter struct
// with the fields n_lm, vdt, wdt, q0, q1, q2, sx, sy, log_norm and lm.
// The yaw noise is added after the wrapped step, with no second wrap.
// Returns the log-likelihood; x, y and yaw are updated in place.
template <int MODE, class P>
__device__ __forceinline__ float predict_loglik(float& x, float& y,
                                                float& yaw, float n0,
                                                float n1, float n2,
                                                const P& prm,
                                                const float* __restrict__ z) {
  float c_o, s_o;
  if (MODE == kNoiseOff) {
    c_o = cosf(yaw);
    s_o = sinf(yaw);
  } else {
    sincos_rad(yaw, &c_o, &s_o);
  }
  x = x + prm.vdt * c_o + n0 * prm.q0;
  y = y + prm.vdt * s_o + n1 * prm.q1;
  yaw = wrap_angle(yaw + prm.wdt) + n2 * prm.q2;

  // Landmarks in the particle's frame (angle pi/2 - yaw, whose cos and
  // sin are sin(yaw) and cos(yaw)) against the observation.
  float c, s;
  if (MODE == kNoiseOff) {
    const float ang = kHalfPi - yaw;
    c = cosf(ang);
    s = sinf(ang);
  } else {
    sincos_rad(yaw, &s, &c);
  }
  float acc = 0.0f;
  for (int li = 0; li < prm.n_lm; ++li) {
    const float dx = prm.lm[2 * li] - x;
    const float dy = prm.lm[2 * li + 1] - y;
    const float px = c * dx - s * dy;
    const float py = s * dx + c * dy;
    const float ddx = (px - __ldg(z + 2 * li)) / prm.sx;
    const float ddy = (py - __ldg(z + 2 * li + 1)) / prm.sy;
    acc = acc - 0.5f * (ddx * ddx + ddy * ddy) - prm.log_norm;
  }
  return acc;
}

// One block's partial row
//   [max lw, sum exp(lw - max), sum exp(2 (lw - max)), x, y, yaw of its
//    best particle, that particle's index, 0]
// over the block's particles (thread t holds particle `idx`, `valid`
// false past the end).  The best particle is the highest index among the
// maxima; a NaN log weight never wins but poisons the sums, so the
// logsumexp of the combined rows goes NaN as in the reference.  An
// all -inf block keeps the shift finite: exp(-inf - m) = 0, no NaN.
// Every thread of the block must call it.
template <int BLOCK>
__device__ __forceinline__ void block_partial_row(bool valid, float lw,
                                                  float x, float y, float yaw,
                                                  int idx, float* row) {
  constexpr int kWarps = BLOCK / 32;
  __shared__ float s_key[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_sum[kWarps], s_sum2[kWarps];
  __shared__ float s_max;
  __shared__ int s_best;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float key = (valid && lw == lw) ? lw : -INFINITY;  // lw != lw: NaN
  int k_idx = valid ? idx : -1;
  warp_arg_max(key, k_idx);
  if (lane == 0) {
    s_key[warp] = key;
    s_idx[warp] = k_idx;
  }
  __syncthreads();
  if (warp == 0) {
    key = lane < kWarps ? s_key[lane] : -INFINITY;
    k_idx = lane < kWarps ? s_idx[lane] : -1;
    warp_arg_max(key, k_idx);
    if (lane == 0) {
      s_max = key;
      s_best = k_idx;
    }
  }
  __syncthreads();
  const float m = s_max;
  const int best = s_best;
  const float e = valid ? expf(lw - fmaxf(m, -1.0e30f)) : 0.0f;
  float sum = warp_sum(e);
  float sum2 = warp_sum(e * e);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_sum2[warp] = sum2;
  }
  __syncthreads();
  if (valid && idx == best) {
    row[3] = x;
    row[4] = y;
    row[5] = yaw;
  }
  if (warp == 0) {
    sum = warp_sum(lane < kWarps ? s_sum[lane] : 0.0f);
    sum2 = warp_sum(lane < kWarps ? s_sum2[lane] : 0.0f);
    if (lane == 0) {
      row[0] = m;
      row[1] = sum;
      row[2] = sum2;
      row[6] = static_cast<float>(best);
      row[7] = 0.0f;
    }
  }
}

}  // namespace tpuslam
