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
//     their exact int32 prefix, inv_tot = 1 / q_tot with one IEEE
//     reciprocal (K4's own law, in the kernel), the boundary law
//     t_j = clip(ceil(n * (cum_j * inv_tot) - offs), 0, n) with t_{n-1}
//     forced to n, built with __fmul_rn / __fsub_rn so nvcc cannot contract
//     it into an FMA; slot i then copies the first particle j with t_j > i,
//     and every log weight restarts at -log n.  Where it does not fire the
//     log weights are normalized (lw - lse), or reset to -log n where bad;
//   * predict and the landmark log-likelihood against the filter's own
//     observation row (pf_math.cuh, shared with K2 and K5b);
//   * the filter's new lse, lse2 and MAP particle (the highest index among
//     the maxima, as the JAX package's combine picks), reduced inside the
//     block, plus the gate's ess, fire and bad flags.
//
// What bounds it on an H100: instruction issue, not bytes.  A particle
// reads 16 bytes and writes 16 a step (0.078 ms at 8192 x 1000), but its
// math (Philox, two Box-Muller pairs, two polynomial sincos, the wrap,
// ten quotients by the observation std, an exp) is several hundred
// instructions, which the SMs issue in about 0.12-0.17 ms.  The design
// spends as little as it can beside that math:
//   * each quotient by sx or sy is three operations on a host-folded
//     reciprocal (pf_math.cuh::div_by_const), the IEEE divide's bits
//     without its sequence and its branch to a slow path; one warp vote a
//     pass sends a pass that may need the IEEE divide back to it;
//   * the filter's x, y, yaw and log-weight rows (four contiguous spans of
//     4n bytes) are staged in shared memory once, by one thread's four 1D
//     bulk asynchronous copies (cp.async.bulk, completion counted in bytes
//     on an mbarrier) that overlap the gate; where the spans are not
//     16-byte aligned (n % 4 != 0) the block copies them with coalesced
//     loads instead.  Both paths then read shared memory only;
//   * contiguous ownership: thread t owns particles [tP, tP + P) of each
//     pass of kSpan particles (one pass at n <= 1024), read as float4 from
//     shared memory and written as float4 where the rows are aligned.  On
//     a firing filter the thread quantizes and scans its P weights in
//     registers, one block scan of the per-thread totals (two barriers)
//     finishes the prefix, and each slot's source is found by a probe of
//     the previous slot's source and its successor, else a binary search
//     (the sources rise along the slots);
//   * the P particles' math runs in registers with independent chains, and
//     the statistics are reduced once per filter (block_stats_row: warp
//     shuffles, one shared row, the MAP pose carried with its key).
// 256 threads a block (P = 4), held to 64 registers so that four blocks
// share an SM: on an H100 80GB HBM3 at 700 W that took 0.2345 ms at
// 8192 x 1000, against 0.3066 ms at the compiler's own 91 registers (two
// blocks a SM) and 0.3988 ms with 128 threads (P = 8; PERF.md).
// Dynamic shared memory is 20 bytes a particle (kMaxN = 8192: 160 KB),
// allowed once per process and device.
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

#include "occupancy.cuh"
#include "pf_math.cuh"
#include "rows.cuh"

namespace {

using tpuslam::aligned16;
using tpuslam::block_exclusive_scan;
using tpuslam::block_stats_row;
using tpuslam::kMaxLandmarks;
using tpuslam::kNoiseNormals;
using tpuslam::kNoisePhilox;
using tpuslam::kPartStride;
using tpuslam::kTwoPowMinus24;
using tpuslam::philox4x32_10;
using tpuslam::philox_normals3;
using tpuslam::predict_loglik_n;
using tpuslam::Stats;
using tpuslam::stats_add;

constexpr int kThreads = 256;  // held to 64 registers: four blocks a SM
constexpr int kMinBlocks = 4;
constexpr int kSpan = 1024;  // particles a pass of the block
constexpr int kMaxN = 8192;  // 20 bytes a particle of shared memory
constexpr int kMaxSmem = 20 * kMaxN;
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
  float inv_sx, inv_sy;  // 1 / sx, 1 / sy in float32, correctly rounded
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The bulk copy engine's side of the staging: an mbarrier armed for
// `bytes` (its phase 0 completes when they have all landed) and 1D copies
// of 16-byte aligned spans from global to shared memory counted on it.
__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The first j in [lo, hi] with t[j] > i (t non-decreasing, t[hi] > i).
__device__ __forceinline__ int first_above(const int* t, int lo, int hi,
                                           int i) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] > i) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pf_batch_kernel(const __grid_constant__ PfBatchBuffers buf,
                const __grid_constant__ PfBatchParams prm, int b) {
  constexpr int T = kThreads;
  constexpr int P = kSpan / T;  // particles a thread a pass
  static_assert(P % 4 == 0, "a thread's span is whole float4s");
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ float s_z[2 * kMaxLandmarks];
  __shared__ int s_scan[T / 32];
  __shared__ float s_row[kPartStride];

  const int n = prm.n;
  const int n4 = (n + 3) & ~3;
  float* s_x = smem;
  float* s_y = smem + n4;
  float* s_yaw = smem + 2 * n4;
  float* s_lw = smem + 3 * n4;
  int* s_t = reinterpret_cast<int*>(smem + 4 * n4);
  const int t = threadIdx.x;
  const int f = blockIdx.x;
  const long long row = static_cast<long long>(f) * n;
  const long long plane = static_cast<long long>(b) * n;
  const float* x_in = buf.p_in + row;
  const float* lw_in = buf.lw_in + row;
  const unsigned bar = smem_u32(&s_bar);

  // Stage the filter's rows: bulk copies where the spans are 16-byte
  // aligned, coalesced loads otherwise.
  const bool aligned = (n & 3) == 0 && aligned16(buf.p_in) &&
                       aligned16(buf.lw_in);
  if (aligned) {
    if (t == 0) {
      const unsigned bytes = 4u * static_cast<unsigned>(n);
      mbar_arm(bar, 4 * bytes);
      bulk_copy(s_x, x_in, bytes, bar);
      bulk_copy(s_y, x_in + plane, bytes, bar);
      bulk_copy(s_yaw, x_in + 2 * plane, bytes, bar);
      bulk_copy(s_lw, lw_in, bytes, bar);
    }
  } else {
    for (int j = t; j < n; j += T) {
      s_x[j] = x_in[j];
      s_y[j] = x_in[plane + j];
      s_yaw[j] = x_in[2 * plane + j];
      s_lw[j] = lw_in[j];
    }
  }
  if (t < 2 * prm.n_lm) {
    s_z[t] = buf.z[static_cast<long long>(f) * 2 * prm.n_lm + t];
  }

  // The gate, from the carried normalizers, while the copies land.
  const float lse = buf.lse_in[f];
  const float lse2 = buf.lse2_in[f];
  const bool bad = !(isfinite(lse) && isfinite(lse2));
  const float ess = bad ? static_cast<float>(n) : expf(2.0f * lse - lse2);
  const bool fire = !bad && ess < prm.ess_min;  // uniform across the block
  float offs = 0.5f;
  if (buf.offs != nullptr) {
    offs = buf.offs[f];
  } else if (MODE == kNoisePhilox && fire) {
    const uint4 r = philox4x32_10(
        make_uint4(0u, static_cast<uint32_t>(f), 1u, 0u),
        make_uint2(prm.key0, prm.key1));
    offs = static_cast<float>(r.x >> 8) * kTwoPowMinus24;
  }
  __syncthreads();  // s_z and the mbarrier's init, or the loaded rows
  if (aligned) mbar_wait(bar, 0);

  if (fire) {
    // Quantized weights and their exact inclusive prefix: P in registers
    // a thread, then one block scan a pass of the per-thread totals.
    int carry = 0;
    for (int base = 0; base < n; base += kSpan) {
      const int j0 = base + t * P;
      int cum[P];
      int run = 0;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = j0 + k;
        if (j < n) {
          const float w = expf(s_lw[j] - lse);
          run += static_cast<int>(rintf(w * kQuantum));
        }
        cum[k] = run;
      }
      int total;
      const int before = carry + block_exclusive_scan<T>(run, s_scan, total);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (j0 + k < n) s_t[j0 + k] = before + cum[k];
      }
      carry += total;
    }
    // Each thread turns its own prefixes into boundaries.
    const float inv_tot = __frcp_rn(static_cast<float>(carry));
    const float nf = static_cast<float>(n);
    for (int base = 0; base < n; base += kSpan) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = base + t * P + k;
        if (j < n) {
          const float scaled = __fmul_rn(
              nf, __fmul_rn(static_cast<float>(s_t[j]), inv_tot));
          float tb = ceilf(__fsub_rn(scaled, offs));
          tb = fminf(fmaxf(tb, 0.0f), nf);
          if (j >= n - 1) tb = nf;  // the last particle takes the rest
          s_t[j] = static_cast<int>(tb);
        }
      }
    }
    __syncthreads();
  }

  const bool vec_out = (n & 3) == 0 && aligned16(buf.p_out) &&
                       aligned16(buf.lw_out) &&
                       (buf.sel_out == nullptr || aligned16(buf.sel_out));
  const bool vec_nrm = (n & 3) == 0 && aligned16(buf.normals);
  Stats st;
  for (int base = 0; base < n; base += kSpan) {
    const int j0 = base + t * P;
    float x[P], y[P], yaw[P], lw[P], n0[P], n1[P], n2[P], acc[P];
    int idx[P], src[P];
    bool valid[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      idx[k] = j0 + k;
      valid[k] = j0 + k < n;
    }
    if (fire) {
      // Each slot's source: the first j with t_j > slot.  Sources rise
      // along the slots, so a slot first probes its predecessor's source
      // and the one after it.
      int s = j0 < n ? first_above(s_t, 0, n - 1, j0) : 0;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int i = j0 + k;
        if (k > 0 && i < n && s_t[s] <= i) {
          ++s;
          if (s < n - 1 && s_t[s] <= i) s = first_above(s_t, s + 1, n - 1, i);
        }
        src[k] = s;
        x[k] = s_x[s];
        y[k] = s_y[s];
        yaw[k] = s_yaw[s];
        lw[k] = prm.neg_log_n;
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        if (j0 + k >= n) break;  // shared memory ends at the last float4
        const float4 a = *reinterpret_cast<const float4*>(s_x + j0 + k);
        const float4 c = *reinterpret_cast<const float4*>(s_y + j0 + k);
        const float4 d = *reinterpret_cast<const float4*>(s_yaw + j0 + k);
        const float4 e = *reinterpret_cast<const float4*>(s_lw + j0 + k);
        x[k] = a.x; x[k + 1] = a.y; x[k + 2] = a.z; x[k + 3] = a.w;
        y[k] = c.x; y[k + 1] = c.y; y[k + 2] = c.z; y[k + 3] = c.w;
        yaw[k] = d.x; yaw[k + 1] = d.y; yaw[k + 2] = d.z; yaw[k + 3] = d.w;
        lw[k] = e.x; lw[k + 1] = e.y; lw[k + 2] = e.z; lw[k + 3] = e.w;
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        src[k] = j0 + k;
        lw[k] = bad ? prm.neg_log_n : lw[k] - lse;
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      n0[k] = n1[k] = n2[k] = 0.0f;
      if (MODE == kNoisePhilox) {
        philox_normals3(static_cast<uint32_t>(j0 + k),
                        static_cast<uint32_t>(f), prm.key0, prm.key1, n0[k],
                        n1[k], n2[k]);
      }
    }
    if (MODE == kNoiseNormals) {
      const float* nr = buf.normals + row;
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        const int j = j0 + k;
        if (vec_nrm && j < n) {
          const float4 a = *reinterpret_cast<const float4*>(nr + j);
          const float4 c = *reinterpret_cast<const float4*>(nr + plane + j);
          const float4 d =
              *reinterpret_cast<const float4*>(nr + 2 * plane + j);
          n0[k] = a.x; n0[k + 1] = a.y; n0[k + 2] = a.z; n0[k + 3] = a.w;
          n1[k] = c.x; n1[k + 1] = c.y; n1[k + 2] = c.z; n1[k + 3] = c.w;
          n2[k] = d.x; n2[k + 1] = d.y; n2[k + 2] = d.z; n2[k + 3] = d.w;
        } else if (!vec_nrm) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j + e < n) {
              n0[k + e] = nr[j + e];
              n1[k + e] = nr[plane + j + e];
              n2[k + e] = nr[2 * plane + j + e];
            }
          }
        }
      }
    }
    predict_loglik_n<MODE, P>(x, y, yaw, n0, n1, n2, prm, s_z, valid,
                              acc);
#pragma unroll
    for (int k = 0; k < P; ++k) lw[k] = lw[k] + acc[k];

    float* xo = buf.p_out + row;
    float* lwo = buf.lw_out + row;
    int* so = buf.sel_out == nullptr ? nullptr : buf.sel_out + row;
#pragma unroll
    for (int k = 0; k < P; k += 4) {
      const int j = j0 + k;
      if (vec_out && j < n) {
        *reinterpret_cast<float4*>(xo + j) =
            make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
        *reinterpret_cast<float4*>(xo + plane + j) =
            make_float4(y[k], y[k + 1], y[k + 2], y[k + 3]);
        *reinterpret_cast<float4*>(xo + 2 * plane + j) =
            make_float4(yaw[k], yaw[k + 1], yaw[k + 2], yaw[k + 3]);
        *reinterpret_cast<float4*>(lwo + j) =
            make_float4(lw[k], lw[k + 1], lw[k + 2], lw[k + 3]);
        if (so != nullptr) {
          *reinterpret_cast<int4*>(so + j) =
              make_int4(src[k], src[k + 1], src[k + 2], src[k + 3]);
        }
      } else if (!vec_out) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < n) {
            xo[j + e] = x[k + e];
            xo[plane + j + e] = y[k + e];
            xo[2 * plane + j + e] = yaw[k + e];
            lwo[j + e] = lw[k + e];
            if (so != nullptr) so[j + e] = src[k + e];
          }
        }
      }
    }
    stats_add(st, lw, x, y, yaw, idx, valid);
  }

  block_stats_row<T>(st, s_row);
  if (t == 0) {
    buf.lse_out[f] = s_row[0] + logf(s_row[1]);
    buf.lse2_out[f] = 2.0f * s_row[0] + logf(s_row[2]);
    buf.ess_out[f] = ess;
    buf.fire_out[f] = fire ? 1 : 0;
    buf.bad_out[f] = bad ? 1 : 0;
    buf.est_out[3 * f] = s_row[3];
    buf.est_out[3 * f + 1] = s_row[4];
    buf.est_out[3 * f + 2] = s_row[5];
  }
}

// q = a / s over a row as predict_loglik_n takes its quotients:
// div_by_const where the divisor and the operand are in its exact range,
// the IEEE divide elsewhere; with law_only, div_by_const everywhere.  A
// check of the law on the card (tpuslam_div_by_const); no path runs it.
__global__ void div_by_const_kernel(const float* __restrict__ a,
                                    float* __restrict__ q, long long n,
                                    float s, float inv, bool law_only) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const float v = a[i];
  q[i] = law_only || (tpuslam::div_divisor_ok(s) && tpuslam::div_exact(v))
             ? tpuslam::div_by_const(v, s, inv)
             : v / s;
}

// Allow the largest shared-memory request, once per device.
template <int MODE>
int allow_smem() {
  static unsigned allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(allowed & (1u << dev)))) {
    err = cudaFuncSetAttribute(pf_batch_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err == cudaSuccess && dev < 32) allowed |= 1u << dev;
  }
  return static_cast<int>(err);
}

size_t smem_bytes(int n) { return 20 * static_cast<size_t>((n + 3) & ~3); }

template <int MODE>
int launch(const PfBatchBuffers& buf, const PfBatchParams& prm, int b,
           cudaStream_t stream) {
  const int err = allow_smem<MODE>();
  if (err != 0) return err;
  pf_batch_kernel<MODE><<<b, kThreads, smem_bytes(prm.n), stream>>>(buf, prm,
                                                                    b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes.  buffers: a PfBatchBuffers, params: a
// PfBatchParams template (every field but the key), both in host memory;
// the template stays read-only: the entry copies it and sets the key
// (seed_lo, seed_hi).  b: filters.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.
extern "C" int tpuslam_pf_batch_step(const void* buffers, const void* params,
                                     uint32_t seed_lo, uint32_t seed_hi,
                                     int b, int mode, void* stream) {
  const PfBatchBuffers& buf = *static_cast<const PfBatchBuffers*>(buffers);
  PfBatchParams p = *static_cast<const PfBatchParams*>(params);
  p.key0 = seed_lo;
  p.key1 = seed_hi;
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

// The count of K4's warp-passes whose landmark quotients needed the IEEE
// divide (pf_math.cuh::g_div_fallbacks) on the current device, since the
// library was loaded, into *value.  Synchronises with the device: a
// check, not for the loop.
extern "C" int tpuslam_pf_batch_div_fallbacks(unsigned int* value) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      value, tpuslam::g_div_fallbacks, sizeof(unsigned int)));
}

// q = a / s for n floats on the device, by div_by_const_kernel; inv is
// the host's RN(1 / s).  Launches on `stream` and returns
// cudaGetLastError(); never synchronises.
extern "C" int tpuslam_div_by_const(const float* a, float* q, long long n,
                                    float s, float inv, int law_only,
                                    void* stream) {
  constexpr int kT = 256;
  if (n < 1 || (n + kT - 1) / kT > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  div_by_const_kernel<<<static_cast<unsigned>((n + kT - 1) / kT), kT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, q, n, s, inv, law_only != 0);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of K4 (Philox mode) at n particles a filter,
// *name its name; cudaErrorInvalidValue past the last (which > 0).
extern "C" int tpuslam_occupancy_pf_batch(int which, int n, int* blocks,
                                          const char** name) {
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  *name = "K4 pf_batch";
  const int err = allow_smem<1>();
  if (err != 0) return err;
  return tpuslam::occupancy(pf_batch_kernel<1>, "K4 pf_batch", kThreads,
                            smem_bytes(n), blocks, name);
}
