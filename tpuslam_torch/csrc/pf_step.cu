// K2: the fused particle-filter step (predict + log-likelihood weight +
// the step's reductions), one launch a step.
//
// Replaces tpuslam/ops/pf_pallas.py::_pf_stats_kernel (K2b, with the
// reductions) and ::_pf_kernel (K2a, without them; the STATS template
// flag).  Each particle takes the circular step with Q noise, the five
// landmarks are moved into its frame and compared with the observation,
// and the summed log-likelihood is added to its log weight
// (particle_filter.py:156-198).  With STATS, a flag resets the incoming
// log weights to uniform (the reference's NaN->uniform reset, applied in
// the pass) and every block writes one partial row
//   [max lw, sum exp(lw - max), sum exp(2 (lw - max)), x, y, yaw of its
//    best particle, that particle's index, 0]
// that ops/pf_cuda.py::_combine_stats reduces to logsumexp(lw),
// logsumexp(2 lw) and the MAP particle.
//
// What bounds it on an H100: bytes.  A particle reads 12 bytes of pose and
// 4 of log weight and writes as many, 32 bytes a step; its arithmetic is a
// few hundred operations (one Philox4x32-10 call, two Box-Muller
// transforms, two polynomial sincos, five landmark terms with two
// divides each, one exp), which the card's float rate covers in less time
// than the bytes take.  So the design is one pass over the particles with
// coalesced structure-of-arrays loads and stores:
//   * one thread per particle, rows (3, N) and (N,) read and written once;
//   * counter-based noise (Philox keyed by the step's seed, counter =
//     (particle index, 0, 0, 0)), so the stream does not depend on the
//     block size and no generator state is loaded or stored;
//   * the TPU kernel carried nothing across its sequential grid but wrote
//     per-tile partials; here blocks run in parallel, and each reduces its
//     256 particles with warp shuffles to one partial row.  The MAP pick
//     is the highest flat index among the maxima, whatever the block size.
// No sub-row packing and no padding: those filled TPU sublanes.  The
// ragged last block is masked.
//
// Modes: 0 = noise off (builtin sinf/cosf, for parity with the plain
// path), 1 = Philox noise, 2 = caller-supplied standard normals of shape
// (3, N).  Modes 1 and 2 use the polynomial sincos.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fastmath.cuh"

namespace {

using tpuslam::kHalfPi;
using tpuslam::normals_from_bits;
using tpuslam::philox4x32_10;
using tpuslam::sincos_rad;
using tpuslam::wrap_angle;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxLandmarks = 8;
constexpr int kPartStride = 8;
constexpr unsigned kFull = 0xffffffffu;

// Host-folded constants; the layout matches ops/pf_cuda.py::_PfParams.
struct PfParams {
  long long n;
  uint32_t key0, key1;
  int n_lm;
  float flag;          // > 0: treat incoming log weights as 0 (uniform)
  float vdt, wdt;      // v*dt, w*dt (folded in double)
  float q0, q1, q2;    // q_std
  float sx, sy;        // r_std
  float log_norm;      // log(2 pi sx sy) (folded in double)
  float lm[2 * kMaxLandmarks];  // landmark (x, y) pairs
};

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
    arg_max(key, idx, __shfl_down_sync(kFull, key, d),
            __shfl_down_sync(kFull, idx, d));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(kBlock)
pf_step_kernel(const float* __restrict__ p_in,
               const float* __restrict__ lw_in, const float* __restrict__ z,
               const float* __restrict__ normals, float* __restrict__ p_out,
               float* __restrict__ lw_out, float* __restrict__ parts,
               const PfParams prm) {
  const long long n = prm.n;
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  const bool valid = i < n;
  float x = 0.0f, y = 0.0f, yaw = 0.0f, lw = -INFINITY;
  if (valid) {
    x = p_in[i];
    y = p_in[n + i];
    yaw = p_in[2 * n + i];
    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
    if (MODE == 1) {
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(i), 0u, 0u, 0u),
          make_uint2(prm.key0, prm.key1));
      const float2 a = normals_from_bits(r.x, r.y);
      const float2 b = normals_from_bits(r.z, r.w);
      n0 = a.x;
      n1 = a.y;
      n2 = b.x;
    } else if (MODE == 2) {
      n0 = normals[i];
      n1 = normals[n + i];
      n2 = normals[2 * n + i];
    }

    // Predict (particle_filter.py:156-168); the yaw noise is added after
    // the wrapped step, with no second wrap.
    float c_o, s_o;
    if (MODE == 0) {
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
    if (MODE == 0) {
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
    const float lw0 = (STATS && prm.flag > 0.0f) ? 0.0f : lw_in[i];
    lw = lw0 + acc;
    p_out[i] = x;
    p_out[n + i] = y;
    p_out[2 * n + i] = yaw;
    lw_out[i] = lw;
  }
  if (!STATS) return;

  // Block max and MAP index; a NaN log weight never wins but poisons the
  // sums below, so logsumexp goes NaN as in the reference.
  __shared__ float s_key[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_sum[kWarps], s_sum2[kWarps];
  __shared__ float s_max;
  __shared__ int s_best;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float key = (valid && lw == lw) ? lw : -INFINITY;  // lw != lw: NaN
  int idx = valid ? static_cast<int>(i) : -1;
  warp_arg_max(key, idx);
  if (lane == 0) {
    s_key[warp] = key;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    key = lane < kWarps ? s_key[lane] : -INFINITY;
    idx = lane < kWarps ? s_idx[lane] : -1;
    warp_arg_max(key, idx);
    if (lane == 0) {
      s_max = key;
      s_best = idx;
    }
  }
  __syncthreads();
  const float m = s_max;
  const int best = s_best;
  // An all -inf block keeps the shift finite: exp(-inf - m) = 0, no NaN.
  const float e = valid ? expf(lw - fmaxf(m, -1.0e30f)) : 0.0f;
  float sum = warp_sum(e);
  float sum2 = warp_sum(e * e);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_sum2[warp] = sum2;
  }
  __syncthreads();
  float* row = parts + static_cast<long long>(blockIdx.x) * kPartStride;
  if (valid && static_cast<int>(i) == best) {
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

template <int MODE>
void launch(bool with_stats, unsigned grid, cudaStream_t stream,
            const float* p_in, const float* lw_in, const float* z,
            const float* normals, float* p_out, float* lw_out, float* parts,
            const PfParams& prm) {
  if (with_stats) {
    pf_step_kernel<MODE, true><<<grid, kBlock, 0, stream>>>(
        p_in, lw_in, z, normals, p_out, lw_out, parts, prm);
  } else {
    pf_step_kernel<MODE, false><<<grid, kBlock, 0, stream>>>(
        p_in, lw_in, z, normals, p_out, lw_out, parts, prm);
  }
}

}  // namespace

// C entry point for ctypes.  p_in/p_out: (3, n) rows; lw_in/lw_out: (n,);
// z: (n_lm, 2) observation on the device; normals: (3, n) in mode 2, else
// unused; parts: (ceil(n / 256), 8) when with_stats.  Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted); never
// synchronises.
extern "C" int tpuslam_pf_step(const float* p_in, const float* lw_in,
                               const float* z, const float* normals,
                               float* p_out, float* lw_out, float* parts,
                               const void* params, int mode, int with_stats,
                               void* stream) {
  const PfParams& p = *static_cast<const PfParams*>(params);
  if (p.n < 1 || p.n >= (1LL << 24) || p.n_lm < 0 ||
      p.n_lm > kMaxLandmarks || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((p.n + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = with_stats != 0;
  switch (mode) {
    case 0: launch<0>(st, grid, s, p_in, lw_in, z, normals, p_out, lw_out, parts, p); break;
    case 1: launch<1>(st, grid, s, p_in, lw_in, z, normals, p_out, lw_out, parts, p); break;
    default: launch<2>(st, grid, s, p_in, lw_in, z, normals, p_out, lw_out, parts, p); break;
  }
  return static_cast<int>(cudaGetLastError());
}
