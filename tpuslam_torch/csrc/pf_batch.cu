// K4: the batched particle filter's whole step, one launch a step.
//
// Replaces tpuslam/ops/pf_batch_pallas.py::_pf_batch_kernel.  B
// independent filters of n particles each (the reference's own scale is
// 1000, particle_filter.py:31) advance in lockstep; one block serves one
// filter and does, in order (main_pf, particle_filter.py:86-119):
//   * the ESS gate from the filter's carried normalizers (lse = logsumexp
//     of its log weights, lse2 = logsumexp of twice them): bad = either is
//     not finite, ess = exp(2 lse - lse2), fire = !bad && ess < n * frac.
//     The JAX package computed this in XLA before its kernel; here it is
//     read on the device, so no host decision and no host sync a step;
//   * where it fires, the systematic resample: weights exp(lw - lse)
//     quantized to integers of 2^-20 (rintf: half to even, as jnp.round),
//     their exact int32 block scan, inv_tot = 1 / q_tot with one IEEE
//     reciprocal (K4's own law, in the kernel), the boundary law
//     t_j = clip(ceil(n * (cum_j * inv_tot) - offs), 0, n) with t_{n-1}
//     forced to n, built with __fmul_rn / __fsub_rn so nvcc cannot contract
//     it into an FMA; slot i then copies the first particle j with t_j > i
//     (a binary search over the boundaries in shared memory), and every log
//     weight restarts at -log n.  Where it does not fire the log weights
//     are normalized (lw - lse), or reset to -log n where bad;
//   * predict and the landmark log-likelihood against the filter's own
//     observation row (pf_math.cuh, shared with K2 and K5b);
//   * the filter's new lse, lse2 and MAP particle (the highest index among
//     the maxima, as the JAX package's combine picks), reduced inside the
//     block, plus the gate's ess, fire and bad flags.
//
// What bounds it on an H100: bytes.  A particle reads 16 bytes and writes
// 16 a step (pose and log weight); the gate, the observation and the
// per-filter outputs are a few dozen bytes a filter; the arithmetic is
// K2's few hundred operations a particle plus, on a firing filter, an exp,
// a scan and a search of log2(n) steps a particle.  So: one block of 256
// threads a filter, coalesced loads of its contiguous rows, the filter's
// particles and boundaries in shared memory only while it resamples
// (20 bytes a particle in all, 20 KB at 1000 particles), and the
// reductions in shared memory, so nothing is written twice.
//
// What does not come across from the TPU kernel: the sublane packing, the
// bf16 three-way splits and one-hot MXU matmuls of the in-tile cumsum and
// expansion, the compact_cap survivor compaction and its P x P fallback,
// several filters a grid cell, and the per-column partial rows with their
// XLA combine.  The selection law and the values are the JAX package's.
//
// Noise: 0 = off (offset 0.5, builtin trig), 1 = Philox keyed by the
// step's seed, normals from counter (particle, filter, 0, 0) and the comb
// offset from counter (0, filter, 1, 0), 2 = caller-supplied normals
// (3, B, n).  A caller-supplied (B,) offset row replaces the offset in any
// mode.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "pf_math.cuh"

namespace {

using tpuslam::arg_max;
using tpuslam::kNoiseNormals;
using tpuslam::kNoisePhilox;
using tpuslam::kTwoPowMinus24;
using tpuslam::philox4x32_10;
using tpuslam::philox_normals3;
using tpuslam::predict_loglik;
using tpuslam::warp_arg_max;
using tpuslam::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLandmarks = 8;
constexpr int kMaxN = 8192;  // 20 bytes a particle of shared memory
constexpr float kQuantum = 1048576.0f;  // 2^20

// Host-folded constants; the layout matches
// ops/pf_batch_cuda.py::_PfBatchParams.
struct PfBatchParams {
  int n;               // particles a filter
  int n_lm;
  uint32_t key0, key1;
  float vdt, wdt;      // v*dt, w*dt (folded in double)
  float q0, q1, q2;    // q_std
  float sx, sy;        // r_std
  float log_norm;      // log(2 pi sx sy) (folded in double)
  float neg_log_n;     // -log(n) (folded in double): the uniform log weight
  float ess_min;       // n * ess_threshold_frac (folded in double)
  float lm[2 * kMaxLandmarks];  // landmark (x, y) pairs
};

// The step's device buffers; the layout matches
// ops/pf_batch_cuda.py::_PfBatchBuffers.
struct PfBatchBuffers {
  const float* p_in;       // (3, B, n) rows x, y, yaw
  const float* lw_in;      // (B, n) log weights
  const float* lse_in;     // (B,) carried logsumexp(lw)
  const float* lse2_in;    // (B,) carried logsumexp(2 lw)
  const float* z;          // (B, n_lm, 2) observations
  const float* normals;    // (3, B, n) in mode 2, else unused
  const float* offs;       // (B,) comb offsets, or null
  float* p_out;            // (3, B, n)
  float* lw_out;           // (B, n)
  float* lse_out;          // (B,)
  float* lse2_out;         // (B,)
  float* est_out;          // (B, 3) MAP particle
  float* ess_out;          // (B,) the gate's ESS
  unsigned char* fire_out;  // (B,) bool: resampled
  unsigned char* bad_out;   // (B,) bool: the NaN reset fired
  int* sel_out;            // (B, n) source particle of each slot, or null
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(tpuslam::kFullMask, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Inclusive scan of one int a thread over the block; `total` gets the
// block's sum.  Every thread must call it.
__device__ __forceinline__ int block_inclusive_scan(int v, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
    w = warp_inclusive_scan(w, lane);
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[kWarps - 1];
  const int out = incl + (warp > 0 ? s_warp[warp - 1] : 0);
  __syncthreads();  // s_warp is reused by the next call
  return out;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pf_batch_kernel(const PfBatchBuffers buf, const PfBatchParams prm, int b) {
  extern __shared__ float smem[];
  __shared__ int s_warp[kWarps];
  __shared__ float s_key[kWarps], s_sum[kWarps], s_sum2[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_max;
  __shared__ int s_best;

  const int n = prm.n;
  float* s_lw = smem;                                // (n,) new log weights
  float* s_p = smem + n;                             // (3, n) on fire
  int* s_t = reinterpret_cast<int*>(smem + 4 * n);   // (n,) on fire
  const int f = blockIdx.x;
  const long long row = static_cast<long long>(f) * n;
  const long long plane = static_cast<long long>(b) * n;

  // The gate, from the carried normalizers.
  const float lse = buf.lse_in[f];
  const float lse2 = buf.lse2_in[f];
  const bool bad = !(isfinite(lse) && isfinite(lse2));
  const float ess = bad ? static_cast<float>(n) : expf(2.0f * lse - lse2);
  const bool fire = !bad && ess < prm.ess_min;
  float offs = 0.5f;
  if (buf.offs != nullptr) {
    offs = buf.offs[f];
  } else if (MODE == kNoisePhilox) {
    const uint4 r = philox4x32_10(
        make_uint4(0u, static_cast<uint32_t>(f), 1u, 0u),
        make_uint2(prm.key0, prm.key1));
    offs = static_cast<float>(r.x >> 8) * kTwoPowMinus24;
  }

  if (fire) {  // uniform across the block: it depends on f only
    // Quantized weights and their exact inclusive prefix, chunk by chunk.
    int carry = 0;
    for (int base = 0; base < n; base += kThreads) {
      const int j = base + threadIdx.x;
      int q = 0;
      if (j < n) {
        const float w = expf(buf.lw_in[row + j] - lse);
        q = static_cast<int>(rintf(w * kQuantum));
      }
      int total;
      const int incl = block_inclusive_scan(q, s_warp, total);
      if (j < n) s_t[j] = carry + incl;
      carry += total;
    }
    const float inv_tot = __frcp_rn(static_cast<float>(carry));
    const float nf = static_cast<float>(n);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float scaled = __fmul_rn(
          nf, __fmul_rn(static_cast<float>(s_t[j]), inv_tot));
      float t = ceilf(__fsub_rn(scaled, offs));
      t = fminf(fmaxf(t, 0.0f), nf);
      if (j >= n - 1) t = nf;  // the last particle takes the rest
      s_t[j] = static_cast<int>(t);
      s_p[j] = buf.p_in[row + j];
      s_p[n + j] = buf.p_in[plane + row + j];
      s_p[2 * n + j] = buf.p_in[2 * plane + row + j];
    }
    __syncthreads();
  }

  const float* z = buf.z + static_cast<long long>(f) * 2 * prm.n_lm;
  float key = -INFINITY;
  int key_idx = -1;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float x, y, yaw, lw0;
    int src = j;
    if (fire) {
      int lo = 0;
      int hi = n - 1;
      while (lo < hi) {  // the first boundary above slot j
        const int mid = (lo + hi) >> 1;
        if (s_t[mid] > j) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      src = lo;
      x = s_p[src];
      y = s_p[n + src];
      yaw = s_p[2 * n + src];
      lw0 = prm.neg_log_n;
    } else {
      x = buf.p_in[row + j];
      y = buf.p_in[plane + row + j];
      yaw = buf.p_in[2 * plane + row + j];
      lw0 = bad ? prm.neg_log_n : buf.lw_in[row + j] - lse;
    }
    if (buf.sel_out != nullptr) buf.sel_out[row + j] = src;
    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
    if (MODE == kNoisePhilox) {
      philox_normals3(static_cast<uint32_t>(j), static_cast<uint32_t>(f),
                      prm.key0, prm.key1, n0, n1, n2);
    } else if (MODE == kNoiseNormals) {
      n0 = buf.normals[row + j];
      n1 = buf.normals[plane + row + j];
      n2 = buf.normals[2 * plane + row + j];
    }
    const float lw = lw0 + predict_loglik<MODE>(x, y, yaw, n0, n1, n2, prm,
                                                z);
    buf.p_out[row + j] = x;
    buf.p_out[plane + row + j] = y;
    buf.p_out[2 * plane + row + j] = yaw;
    buf.lw_out[row + j] = lw;
    s_lw[j] = lw;
    arg_max(key, key_idx, lw == lw ? lw : -INFINITY, j);  // NaN never wins
  }

  // The filter's maximum and MAP index, then the two exp sums.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_arg_max(key, key_idx);
  if (lane == 0) {
    s_key[warp] = key;
    s_idx[warp] = key_idx;
  }
  __syncthreads();
  if (warp == 0) {
    key = lane < kWarps ? s_key[lane] : -INFINITY;
    key_idx = lane < kWarps ? s_idx[lane] : -1;
    warp_arg_max(key, key_idx);
    if (lane == 0) {
      s_max = key;
      s_best = key_idx;
    }
  }
  __syncthreads();
  const float m = s_max;
  const float shift = isfinite(m) ? m : 0.0f;
  float sum = 0.0f, sum2 = 0.0f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(s_lw[j] - shift);
    sum += e;
    sum2 += e * e;
  }
  sum = warp_sum(sum);
  sum2 = warp_sum(sum2);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_sum2[warp] = sum2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sum = 0.0f;
    sum2 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      sum += s_sum[w];
      sum2 += s_sum2[w];
    }
    buf.lse_out[f] = m + logf(sum);
    buf.lse2_out[f] = 2.0f * m + logf(sum2);
    buf.ess_out[f] = ess;
    buf.fire_out[f] = fire ? 1 : 0;
    buf.bad_out[f] = bad ? 1 : 0;
    const long long best = row + s_best;
    buf.est_out[3 * f] = buf.p_out[best];
    buf.est_out[3 * f + 1] = buf.p_out[plane + best];
    buf.est_out[3 * f + 2] = buf.p_out[2 * plane + best];
  }
}

template <int MODE>
int launch(const PfBatchBuffers& buf, const PfBatchParams& prm, int b,
           cudaStream_t stream) {
  const size_t smem = 5 * sizeof(float) * static_cast<size_t>(prm.n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pf_batch_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pf_batch_kernel<MODE><<<b, kThreads, smem, stream>>>(buf, prm, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes.  buffers: a PfBatchBuffers, params: a
// PfBatchParams, both in host memory; b: filters.  Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted); never
// synchronises.
extern "C" int tpuslam_pf_batch_step(const void* buffers, const void* params,
                                     int b, int mode, void* stream) {
  const PfBatchBuffers& buf = *static_cast<const PfBatchBuffers*>(buffers);
  const PfBatchParams& p = *static_cast<const PfBatchParams*>(params);
  if (b < 1 || p.n < 1 || p.n > kMaxN || p.n_lm < 0 ||
      p.n_lm > kMaxLandmarks || mode < 0 || mode > 2 ||
      (mode == 2 && buf.normals == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(buf, p, b, s);
    case 1: return launch<1>(buf, p, b, s);
    default: return launch<2>(buf, p, b, s);
  }
}
