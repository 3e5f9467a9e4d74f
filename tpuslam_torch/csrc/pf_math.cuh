// Per-particle device math shared by the particle-filter kernels: K2
// (pf_step.cu), K4 (pf_batch.cu) and K5b (pf_wide.cu).
//
// Device twins of ops/pf_cuda.py::_predict_loglik and of the reductions
// of ops/pf_cuda.py::_partial_plain and ops/pf_batch_cuda.py::_map_plain:
// the circular predict with Q noise, the landmark log-likelihood, the
// Philox/Box-Muller draw of a particle's three normals, and the running
// statistics K2b, K4 and K5b reduce inside a block.  A
// particle's operations and their operand order are the plain twin's,
// whatever the number of particles a thread carries.
//
// The landmark loop is unrolled to kMaxLandmarks under a predicate, so a
// landmark is a constant-bank operand of its multiplies and no parameter
// struct is indexed at run time; with P particles a thread, an observed
// landmark is loaded once and used P times, and the P particles' chains
// (Philox, the two polynomial sincos, the quotients) are independent, so
// the scheduler can interleave them.  The quotients by the observation
// std take div_by_const's three operations, not the IEEE divide's
// sequence and its branch to a slow path; one warp vote a pass sends the
// rare pass that may need the IEEE divide back to it.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fastmath.cuh"

namespace tpuslam {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPartStride = 8;  // floats a statistics row
constexpr int kMaxLandmarks = 8;

// Noise modes of every PF kernel: off (builtin sinf/cosf, for parity with
// the plain path), Philox, or caller-supplied standard normals.  Modes 1
// and 2 use the polynomial sincos.
constexpr int kNoiseOff = 0;
constexpr int kNoisePhilox = 1;
constexpr int kNoiseNormals = 2;

// The exact range of div_by_const (below): a divisor s with
// 2^-20 <= |s| <= 2^20 and an operand a = 0 or 2^-100 <= |a| < 2^100.
constexpr float kDivMinS = 0x1p-20f;
constexpr float kDivMaxS = 0x1p20f;
constexpr float kDivMinA = 0x1p-100f;
constexpr float kDivMaxA = 0x1p100f;
// An observation coordinate of at least this magnitude keeps every
// nonzero px - zx at least kDivMinA (predict_loglik_n).
constexpr float kDivMinZ = 0x1p-76f;

// Warp-passes of predict_loglik_n whose quotients needed the IEEE divide,
// since the library was loaded: one count a source file, read by its
// tpuslam_<source>_div_fallbacks entry.
namespace {
__device__ unsigned int g_div_fallbacks = 0;
}

// a / s, the IEEE quotient, for a divisor s whose correctly rounded
// float32 reciprocal inv = RN(1 / s) the host folded: q = RN(a inv) is a
// faithful quotient in radix 2, the residual e = a - q s is exact, and
// q' = RN(q + e inv) is RN(a / s) (Markstein's theorem) wherever nothing
// underflows or overflows, which holds on div_exact's range.  There the
// bits are a / s's, save that a = -0 gives +0 (q' = RN(-0 + +0)); the
// callers square the quotient.  __fmul_rn and __fmaf_rn keep nvcc from
// contracting or reordering the three operations.
__device__ __forceinline__ float div_by_const(float a, float s, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, s, a), inv, q);
}

// Whether div_by_const(a, s, RN(1 / s)) is a / s: s and a in the exact
// range above.  NaN and +-inf are outside it.
__device__ __forceinline__ bool div_divisor_ok(float s) {
  return fabsf(s) >= kDivMinS && fabsf(s) <= kDivMaxS;
}

__device__ __forceinline__ bool div_exact(float a) {
  const float m = fabsf(a);
  return m == 0.0f || (m >= kDivMinA && m < kDivMaxA);
}

// Whether a row may be read or written as float4s.
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

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

// P particles' predict (particle_filter.py:156-168) and the summed
// log-likelihood of the observation z (n_lm (x, y) pairs in the robot
// frame, at most kMaxLandmarks; particle_filter.py:170-198), each
// particle's operations in the plain twin's order.  `Prm` is a kernel's
// parameter struct with the fields n_lm, vdt, wdt, q0, q1, q2, sx, sy,
// inv_sx, inv_sy, log_norm and lm.  The yaw noise is added after the
// wrapped step, with no second wrap.  x, y and yaw are updated in place;
// acc gets each particle's log-likelihood.  Every lane of the warp calls
// it together (it votes); `valid` marks the particles that exist.
//
// The quotients by sx and sy are div_by_const's, equal to the IEEE
// divide's wherever div_exact holds.  The pass checks that cheaply: a
// nonzero operand px - zx below kDivMinA needs |zx| < kDivMinZ (where
// |zx| >= 2^k, px - zx is 0, or at least 2^(k-24) by Sterbenz's lemma
// where px is within a factor of two of zx, else larger than |zx| / 2),
// and an operand of 2^100 or more, an inf or a NaN leaves a log-likelihood
// that is not finite.  Where some lane sees either, or a divisor outside
// its range, the warp recomputes the pass with the IEEE divide, which
// gives the same bits wherever the quotients were exact, and counts the
// pass in g_div_fallbacks where some operand of a valid particle was
// outside the exact range.
template <int MODE, int P, class Prm>
__device__ __forceinline__ void predict_loglik_n(
    float (&x)[P], float (&y)[P], float (&yaw)[P], const float (&n0)[P],
    const float (&n1)[P], const float (&n2)[P], const Prm& prm,
    const float* __restrict__ z, const bool (&valid)[P], float (&acc)[P]) {
  float c[P], s[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float c_o, s_o;
    if (MODE == kNoiseOff) {
      c_o = cosf(yaw[k]);
      s_o = sinf(yaw[k]);
    } else {
      sincos_rad(yaw[k], &c_o, &s_o);
    }
    x[k] = x[k] + prm.vdt * c_o + n0[k] * prm.q0;
    y[k] = y[k] + prm.vdt * s_o + n1[k] * prm.q1;
    yaw[k] = wrap_angle(yaw[k] + prm.wdt) + n2[k] * prm.q2;
    // Landmarks in the particle's frame (angle pi/2 - yaw, whose cos and
    // sin are sin(yaw) and cos(yaw)) against the observation.
    if (MODE == kNoiseOff) {
      const float ang = kHalfPi - yaw[k];
      c[k] = cosf(ang);
      s[k] = sinf(ang);
    } else {
      sincos_rad(yaw[k], &s[k], &c[k]);
    }
    acc[k] = 0.0f;
  }
  bool odd = !(div_divisor_ok(prm.sx) && div_divisor_ok(prm.sy));
#pragma unroll
  for (int li = 0; li < kMaxLandmarks; ++li) {
    if (li < prm.n_lm) {
      const float lx = prm.lm[2 * li];
      const float ly = prm.lm[2 * li + 1];
      const float zx = z[2 * li];
      const float zy = z[2 * li + 1];
      odd = odd || fabsf(zx) < kDivMinZ || fabsf(zy) < kDivMinZ;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dx = lx - x[k];
        const float dy = ly - y[k];
        const float px = c[k] * dx - s[k] * dy;
        const float py = s[k] * dx + c[k] * dy;
        const float ddx = div_by_const(px - zx, prm.sx, prm.inv_sx);
        const float ddy = div_by_const(py - zy, prm.sy, prm.inv_sy);
        acc[k] = acc[k] - 0.5f * (ddx * ddx + ddy * ddy) - prm.log_norm;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) odd = odd || (valid[k] && !isfinite(acc[k]));
  if (!__any_sync(kFullMask, odd)) return;

  // The rare pass: every quotient again by the IEEE divide, a landmark a
  // trip of a loop that is not unrolled (its code is cold).
  bool off = !(div_divisor_ok(prm.sx) && div_divisor_ok(prm.sy));
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k] = 0.0f;
#pragma unroll 1
  for (int li = 0; li < prm.n_lm; ++li) {
    const float lx = prm.lm[2 * li];
    const float ly = prm.lm[2 * li + 1];
    const float zx = z[2 * li];
    const float zy = z[2 * li + 1];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dx = lx - x[k];
      const float dy = ly - y[k];
      const float px = c[k] * dx - s[k] * dy;
      const float py = s[k] * dx + c[k] * dy;
      off = off || (valid[k] && !(div_exact(px - zx) && div_exact(py - zy)));
      const float ddx = (px - zx) / prm.sx;
      const float ddy = (py - zy) / prm.sy;
      acc[k] = acc[k] - 0.5f * (ddx * ddx + ddy * ddy) - prm.log_norm;
    }
  }
  if (__any_sync(kFullMask, off) && (threadIdx.x & 31) == 0) {
    atomicAdd(&g_div_fallbacks, 1u);
  }
}

// The shift of an exp sum: the maximum clamped to +-1e30, so an all -inf
// set sums exp(-inf) = 0 and a rescale never forms inf - inf, while a
// +inf maximum still sums to +inf as the plain twin's does.
__device__ __forceinline__ float stat_shift(float m) {
  return fminf(fmaxf(m, -1.0e30f), 1.0e30f);
}

// A thread's running statistics over the particles it has seen (K2b,
// K4, K5b): the MAP particle by arg_max (the highest index among the maxima;
// a NaN log weight never wins) and the sums of exp(lw - shift) and of its
// square with shift = stat_shift(key), rescaled whenever the key rises.
// A NaN log weight poisons the sums, so the logsumexp goes NaN as in the
// reference.
struct Stats {
  float key = -INFINITY;
  int idx = -1;
  float x = 0.0f, y = 0.0f, yaw = 0.0f;
  float sum = 0.0f, sum2 = 0.0f;
};

template <int P>
__device__ __forceinline__ void stats_add(Stats& st, const float (&lw)[P],
                                          const float (&x)[P],
                                          const float (&y)[P],
                                          const float (&yaw)[P],
                                          const int (&idx)[P],
                                          const bool (&valid)[P]) {
  const float old_shift = stat_shift(st.key);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float key = lw[k] == lw[k] ? lw[k] : -INFINITY;  // NaN: -inf
    if (valid[k] && (key > st.key || (key == st.key && idx[k] > st.idx))) {
      st.key = key;
      st.idx = idx[k];
      st.x = x[k];
      st.y = y[k];
      st.yaw = yaw[k];
    }
  }
  const float shift = stat_shift(st.key);
  const float r = expf(old_shift - shift);
  float sum = st.sum * r;
  float sum2 = st.sum2 * (r * r);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float e = valid[k] ? expf(lw[k] - shift) : 0.0f;
    sum += e;
    sum2 += e * e;
  }
  st.sum = sum;
  st.sum2 = sum2;
}

// The block's Stats reduced to one row in shared memory:
//   [max lw, sum exp(lw - shift), sum exp(2 (lw - shift)), x, y, yaw of
//    the best particle, its index, 0], shift = stat_shift(max lw),
// in a fixed order (deterministic).  Every thread of the block must call
// it; the row is complete for every thread on return.  Two barriers: the
// second level of the arg-max runs in every warp at once.
template <int T>
__device__ __forceinline__ void block_stats_row(const Stats& st, float* row) {
  constexpr int kW = T / 32;
  __shared__ float s_key[kW], s_sum[kW], s_sum2[kW];
  __shared__ int s_idx[kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float key = st.key;
  int idx = st.idx;
  warp_arg_max(key, idx);
  if (lane == 0) {
    s_key[warp] = key;
    s_idx[warp] = idx;
  }
  __syncthreads();
  key = lane < kW ? s_key[lane] : -INFINITY;
  idx = lane < kW ? s_idx[lane] : -1;
  warp_arg_max(key, idx);
  const float m = __shfl_sync(kFullMask, key, 0);
  const int best = __shfl_sync(kFullMask, idx, 0);
  const float r = expf(stat_shift(st.key) - stat_shift(m));
  float sum = warp_sum(st.sum * r);
  float sum2 = warp_sum(st.sum2 * (r * r));
  if (lane == 0) {
    s_sum[warp] = sum;
    s_sum2[warp] = sum2;
  }
  if (best >= 0 && st.idx == best) {
    row[3] = st.x;
    row[4] = st.y;
    row[5] = st.yaw;
  }
  __syncthreads();
  if (warp == 0) {
    sum = warp_sum(lane < kW ? s_sum[lane] : 0.0f);
    sum2 = warp_sum(lane < kW ? s_sum2[lane] : 0.0f);
    if (lane == 0) {
      row[0] = m;
      row[1] = sum;
      row[2] = sum2;
      row[6] = static_cast<float>(best);
      row[7] = 0.0f;
    }
  }
  __syncthreads();
}

}  // namespace tpuslam
