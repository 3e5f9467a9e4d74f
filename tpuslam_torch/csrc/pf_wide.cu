// K5: the wide batched particle filter's boundary pass (K5a) and its
// predict + weight + statistics pass (K5b).  Between them the segmented
// expand pass of resample.cu (K3b) copies the resampled particles.
//
// Replaces tpuslam/ops/pf_batch_pallas.py::_wide_compact_kernel and
// ::_wide_compact_seg_kernel (K5a and K5a', one kernel here: the planes
// layout of K5a' was a TPU sublane occupancy choice) and
// ::_wide_stats_kernel (K5b, both its plain and its fused form, one
// template with a FUSED flag, as pf_step.cu has STATS).
//
// B filters of n particles each, far more than one block holds (10,000
// in the JAX package's wide benchmark).  Layouts: particles (3, B, n) rows
// x, y, yaw with filter f's particles contiguous, log weights (B, n), no
// padding lanes.  A step (ops/pf_batch_cuda.py::pf_batch_wide_step) is:
//   gate:   the ESS gate of the carried (B,) normalizers, which the step
//           before wrote beside them (K5b, below); the rollout's first
//           step takes it from torch's (B,) ops.
//   K5a:    one block a filter.  Every block counts the firing filters
//           before it (its slot) and in all, and writes the slot
//           compaction: src[f] (filter -> slot), fids[s] (slot -> filter)
//           and valid[s] (s < n_fire).  A filter that does not fire then
//           exits.  A firing filter quantizes its weights, takes their
//           exact prefix and writes its boundaries t_hi in slot order
//           (below).  The JAX package gathers the firing rows first and
//           quantizes them in XLA (pf_batch_pallas.py:1181-1207); here no
//           (B, n) torch op runs and no work is spent on idle filters.
//   K3b:    per (slot, 256 output lanes): each slot's output particle i
//           copies the first particle j of its filter with t_hi[j] > i.
//   K5b:    per filter, one 1024-thread block: on
//           fire[f] the particles come from the expanded rows of slot
//           src[f] and the log weights restart at 0 (the JAX fused form);
//           where bad & !fire they reset to 0; then predict, the landmark
//           log-likelihood and the filter's lse, lse2 and MAP particle,
//           written by the kernel itself, and the ESS gate that the
//           next step reads from them (bad = !(isfinite(lse) &&
//           isfinite(lse2)), ess = bad ? n : expf(2 lse - lse2), fire =
//           !bad && ess < ess_min, the threshold rounded to float32: the
//           law of ops/pf_batch_cuda.py::_gate and of resample.cu's
//           ess_gate, bit for bit), so no torch op runs between steps.
// Every launch happens every step, whatever the gate says: no host
// decision, no host sync.
//
// The survivor compaction of the TPU pass A does not stay.  It existed to
// feed the bf16 one-hot expansion matmuls a bounded (15, t_k) stack; here
// the boundaries themselves feed a binary search per output slot (as in
// the single-filter merge resample, resample.cu), which needs no
// compaction, no survivor cap, no _SLOT_MOD slot keys, no skip table and
// no XLA fallback.
//
// K5a's quantization and boundaries, per firing filter f in slot s, in
// three passes over the row (the second and third from L2), each thread
// taking four consecutive lanes of every tile of 4 x kBoundThreads:
//   1. w_j = expf(lw_j - lse_f) (IEEE subtract) and the row sum total in
//      a fixed order: each thread adds its lanes in sequence, tile by
//      tile, from 0.0f; then a tree of halving IEEE adds over the threads
//      (level h: v[i] += v[i + h]).  ops/pf_batch_cuda.py::
//      wide_row_total_plain takes the same sum, so twin and kernel agree
//      bit for bit;
//   2. scale = 2^20 / total (IEEE divide), wq_j = rintf(w_j * scale)
//      (half to even, as quantize_weights_law), their exact int32
//      inclusive prefix written into t_hi's row;
//   3. inv_tot = __frcp_rn(q_tot) (the twin's IEEE 1 / x) and, in place,
//      the boundary law and forcing of tile_boundary_compact
//      (resample_pallas.py:709-728): t_j = clip(ceil(n * (cum_j *
//      inv_tot) - offs_f), 0, n) by __fmul_rn and __fsub_rn, t_{n-1} = n.
// Each thread reads back only the lanes it wrote.  Rows of any length
// run.  Counting the firing filters costs every block a read of the B
// gate flags, which is small beside a row at the sizes the filter runs.
// On an H100 80GB HBM3 at 700 W, 512 threads a block beat 256 and 1024
// at 240 and 1024 of 1024 x 10,000 filters firing (PERF.md).
//
// What bounds them on an H100.  K5a: bytes (4 of log weight read and 4 of
// boundary written a lane of a firing filter) and, with few firing
// filters, the latency of the passes over one row.  K5b:
// instruction issue.  It moves 16-20 bytes a particle (0.096 ms at
// 1024 x 10,000) but runs K2's several hundred instructions of math a
// particle.  So K5b spends as little as it can beside that math:
//   * four particles a thread a pass, one float4 of each row where a
//     filter's rows are 16-byte aligned (n % 4 == 0), four scalars
//     otherwise; their Philox, sincos and quotient chains are independent,
//     so the scheduler interleaves them.  A warp whose first particle is
//     past the filter's end skips the pass;
//   * the per-filter values (fire, bad, src, the filter's observation)
//     are read once a block into shared memory; the landmarks are
//     constant-bank operands (pf_math.cuh);
//   * the filter's statistics inside the kernel, in a fixed order
//     (deterministic: no atomics, no partial rows in device memory, no
//     combine in torch).  A filter is one block of 1024 threads that
//     loops over it (three passes at 10,000) with a running max and
//     rescaled sums, and reduces them to one (max, sum exp, sum exp^2,
//     MAP index and pose) row in shared memory (block_stats_row), from
//     which thread 0 writes the filter's outputs.
// On an H100 80GB HBM3 at 700 W, one block a filter beat thread-block
// clusters of 256-thread blocks with eight particles a thread (0.2406
// against 0.3437 ms at 1024 x 10,000) and clusters of 512-thread blocks
// (0.3099 ms; PERF.md).

// Noise (K5b): 0 = off (builtin trig), 1 = Philox keyed by the step's seed
// with counter (particle, filter, 0, 0), as K4, 2 = caller-supplied
// normals (3, B, n).

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
using tpuslam::kFullMask;
using tpuslam::kPartStride;
using tpuslam::load4;
using tpuslam::load4_of;
using tpuslam::philox_normals3;
using tpuslam::predict_loglik_n;
using tpuslam::stat_shift;
using tpuslam::Stats;
using tpuslam::stats_add;
using tpuslam::store4;
using tpuslam::store4_of;

constexpr int kBoundThreads = 512;    // K5a's threads a block (a filter)
constexpr int kBoundSpan = 4 * kBoundThreads;  // K5a's lanes a tile
constexpr int kStatsThreads = 1024;   // K5b's threads a block
constexpr int kStatsVec = 1;          // K5b's float4 vectors a thread a pass

// Host-folded constants of K5b; the layout matches
// ops/pf_batch_cuda.py::_WideParams.
struct WideParams {
  int n;               // particles a filter
  int b;               // filters
  int n_lm;
  uint32_t key0, key1;
  float vdt, wdt;      // v*dt, w*dt (folded in double)
  float q0, q1, q2;    // q_std
  float sx, sy;        // r_std
  float inv_sx, inv_sy;  // 1 / sx, 1 / sy in float32, correctly rounded
  float log_norm;      // log(2 pi sx sy) (folded in double)
  float ess_min;       // the gate's threshold n * ess_frac in float32
  float lm[2 * kMaxLandmarks];  // landmark (x, y) pairs
};

// K5b's device buffers; the layout matches
// ops/pf_batch_cuda.py::_WideBuffers.
struct WideBuffers {
  const float* p_in;            // (3, B, n)
  const float* lw_in;           // (B, n)
  const float* z;               // (B, n_lm, 2)
  const float* normals;         // (3, B, n) in mode 2, else unused
  const unsigned char* bad;     // (B,) bool
  const unsigned char* fire;    // (B,) bool
  const int* src;               // (B,) slot of each filter (FUSED)
  const float* expanded;        // (3, B, n) slot rows (FUSED)
  float* p_out;                 // (3, B, n)
  float* lw_out;                // (B, n)
  float* lse_out;               // (B,) logsumexp(lw')
  float* lse2_out;              // (B,) logsumexp(2 lw')
  float* est_out;               // (B, 3) MAP particle
  unsigned char* gate_bad;      // (B,) bool: the next step's gate
  float* gate_ess;              // (B,) its ESS (n where bad)
  unsigned char* gate_fire;     // (B,) bool
};

// w_j of four lanes from j on: expf(lw - lse) on the lanes before n, 0
// past it.
__device__ __forceinline__ float4 weights4(const float* lw, int j, int n,
                                           bool vec, float lse) {
  const float4 v = load4(lw, j, n, vec);
  return make_float4(j < n ? expf(__fsub_rn(v.x, lse)) : 0.0f,
                     j + 1 < n ? expf(__fsub_rn(v.y, lse)) : 0.0f,
                     j + 2 < n ? expf(__fsub_rn(v.z, lse)) : 0.0f,
                     j + 3 < n ? expf(__fsub_rn(v.w, lse)) : 0.0f);
}

__device__ __forceinline__ int quantize(float w, float scale) {
  return static_cast<int>(rintf(__fmul_rn(w, scale)));
}

// K5a, one block a filter (see the file's head).
__global__ void __launch_bounds__(kBoundThreads)
wide_boundary_kernel(const float* __restrict__ log_w,
                     const float* __restrict__ lse_in,
                     const unsigned char* __restrict__ fire,
                     const float* __restrict__ offs_in,
                     int* __restrict__ t_hi, int* __restrict__ fids,
                     unsigned char* __restrict__ valid,
                     int* __restrict__ src, int n, int b) {
  constexpr int T = kBoundThreads;
  __shared__ float s_sum[T];
  __shared__ int s_warp[T / 32];
  const int f = blockIdx.x;
  const int t = threadIdx.x;

  // The slot compaction: filter f's slot is the count of firing filters
  // before it; slots from n_fire on are idle.
  int before = 0, n_fire = 0;
  for (int base = 0; base < b; base += T) {
    const int i = base + t;
    const bool on = i < b && fire[i] != 0;
    before += __syncthreads_count(on && i < f);
    n_fire += __syncthreads_count(on);
  }
  if (t == 0) {
    src[f] = min(before, b - 1);
    if (f >= n_fire) {
      fids[f] = 0;
      valid[f] = 0;
    }
  }
  if (!fire[f]) return;  // the whole block: an idle filter
  const int s = before;
  if (t == 0) {
    fids[s] = f;
    valid[s] = 1;
  }

  const float* lw = log_w + static_cast<long long>(f) * n;
  int* row = t_hi + static_cast<long long>(s) * n;
  const float lse = lse_in[f];
  const bool vec = (n & 3) == 0 && aligned16(log_w) && aligned16(t_hi);

  // 1. The row sum in the fixed order.
  float acc = 0.0f;
  for (int base = 0; base < n; base += kBoundSpan) {
    const float4 w = weights4(lw, base + 4 * t, n, vec, lse);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, w.x), w.y), w.z),
                    w.w);
  }
  s_sum[t] = acc;
  __syncthreads();
#pragma unroll
  for (int h = T / 2; h >= 32; h >>= 1) {
    if (t < h) s_sum[t] = __fadd_rn(s_sum[t], s_sum[t + h]);
    __syncthreads();
  }
  if (t < 32) {
    float v = s_sum[t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v = __fadd_rn(v, __shfl_down_sync(kFullMask, v, d));
    }
    if (t == 0) s_sum[0] = v;
  }
  __syncthreads();
  const float scale = __fdiv_rn(1048576.0f, s_sum[0]);

  // 2. The quantized weights' exact inclusive prefix, into t_hi's row.
  int carry = 0;
  for (int base = 0; base < n; base += kBoundSpan) {
    const int j = base + 4 * t;
    const float4 w = weights4(lw, j, n, vec, lse);
    int4 cum;
    cum.x = quantize(w.x, scale);
    cum.y = cum.x + quantize(w.y, scale);
    cum.z = cum.y + quantize(w.z, scale);
    cum.w = cum.z + quantize(w.w, scale);
    int total;
    const int pre = carry + block_exclusive_scan<T>(cum.w, s_warp, total);
    store4_of(row, j, n, vec,
              make_int4(pre + cum.x, pre + cum.y, pre + cum.z, pre + cum.w));
    carry += total;
  }

  // 3. The boundaries, in place; each thread reads its own lanes back.
  const float inv_tot = __frcp_rn(static_cast<float>(carry));
  const float nf = static_cast<float>(n);
  const float offs = offs_in[f];
  for (int base = 0; base < n; base += kBoundSpan) {
    const int j = base + 4 * t;
    const int4 c = load4_of<int4>(row, j, n, vec);
    int tb[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float scaled =
          __fmul_rn(nf, __fmul_rn(static_cast<float>(tb[k]), inv_tot));
      float v = ceilf(__fsub_rn(scaled, offs));
      v = fminf(fmaxf(v, 0.0f), nf);
      if (j + k >= n - 1) v = nf;  // the last particle takes the rest
      tb[k] = static_cast<int>(v);
    }
    store4_of(row, j, n, vec, make_int4(tb[0], tb[1], tb[2], tb[3]));
  }
}

// K5b, one block a filter.
template <int MODE, bool FUSED>
__global__ void __launch_bounds__(kStatsThreads, 1)
wide_stats_kernel(const __grid_constant__ WideBuffers buf,
                  const __grid_constant__ WideParams prm) {
  constexpr int T = kStatsThreads;
  constexpr int V = kStatsVec;
  constexpr int P = 4 * V;  // particles a thread a pass
  __shared__ float s_z[2 * kMaxLandmarks];
  __shared__ int s_filter[3];  // fire, bad, src
  __shared__ float s_row[kPartStride];

  const int n = prm.n;
  const int f = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 2 * prm.n_lm) {
    s_z[t] = buf.z[static_cast<long long>(f) * 2 * prm.n_lm + t];
  }
  if (t == 0) {
    s_filter[0] = buf.fire[f];
    s_filter[1] = buf.bad[f];
    s_filter[2] = FUSED ? buf.src[f] : 0;
  }
  __syncthreads();
  const bool fire = s_filter[0] != 0;
  const bool take = FUSED && fire;  // the uniform restart after a resample
  const bool restart = take || (s_filter[1] != 0 && !fire);  // or NaN reset
  const long long row = static_cast<long long>(f) * n;
  const long long plane = static_cast<long long>(prm.b) * n;
  const float* x_in =
      take ? buf.expanded + static_cast<long long>(s_filter[2]) * n
           : buf.p_in + row;
  const float* lw_in = buf.lw_in + row;
  const float* nr = buf.normals + row;
  float* x_out = buf.p_out + row;
  float* lw_out = buf.lw_out + row;
  const bool vec = (n & 3) == 0 && aligned16(buf.p_in) &&
                   aligned16(buf.lw_in) && aligned16(buf.p_out) &&
                   aligned16(buf.lw_out) &&
                   (!FUSED || aligned16(buf.expanded)) &&
                   (MODE != kNoiseNormals || aligned16(buf.normals));

  Stats st;
  for (int base = 0; base < n; base += T * P) {
    // A warp whose first particle lies past the end has none left.
    if (base + 4 * (t & ~31) >= n) break;
    float x[P], y[P], yaw[P], lw[P], n0[P], n1[P], n2[P], acc[P];
    int idx[P];
    bool valid[P];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = base + 4 * (v * T + t);
      const float4 a = load4(x_in, j, n, vec);
      const float4 c = load4(x_in + plane, j, n, vec);
      const float4 d = load4(x_in + 2 * plane, j, n, vec);
      const float4 e = restart ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                               : load4(lw_in, j, n, vec);
      const int k = 4 * v;
      x[k] = a.x; x[k + 1] = a.y; x[k + 2] = a.z; x[k + 3] = a.w;
      y[k] = c.x; y[k + 1] = c.y; y[k + 2] = c.z; y[k + 3] = c.w;
      yaw[k] = d.x; yaw[k + 1] = d.y; yaw[k + 2] = d.z; yaw[k + 3] = d.w;
      lw[k] = e.x; lw[k + 1] = e.y; lw[k + 2] = e.z; lw[k + 3] = e.w;
      if (MODE == kNoiseNormals) {
        const float4 g = load4(nr, j, n, vec);
        const float4 h = load4(nr + plane, j, n, vec);
        const float4 q = load4(nr + 2 * plane, j, n, vec);
        n0[k] = g.x; n0[k + 1] = g.y; n0[k + 2] = g.z; n0[k + 3] = g.w;
        n1[k] = h.x; n1[k + 1] = h.y; n1[k + 2] = h.z; n1[k + 3] = h.w;
        n2[k] = q.x; n2[k + 1] = q.y; n2[k + 2] = q.z; n2[k + 3] = q.w;
      }
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        idx[k + e4] = j + e4;
        valid[k + e4] = j + e4 < n;
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (MODE == kNoisePhilox) {
        philox_normals3(static_cast<uint32_t>(idx[k]),
                        static_cast<uint32_t>(f), prm.key0, prm.key1, n0[k],
                        n1[k], n2[k]);
      } else if (MODE != kNoiseNormals) {
        n0[k] = n1[k] = n2[k] = 0.0f;
      }
    }
    predict_loglik_n<MODE, P>(x, y, yaw, n0, n1, n2, prm, s_z, valid,
                              acc);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = base + 4 * (v * T + t);
      const int k = 4 * v;
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) lw[k + e4] = lw[k + e4] + acc[k + e4];
      store4(x_out, j, n, vec, make_float4(x[k], x[k + 1], x[k + 2],
                                           x[k + 3]));
      store4(x_out + plane, j, n, vec,
             make_float4(y[k], y[k + 1], y[k + 2], y[k + 3]));
      store4(x_out + 2 * plane, j, n, vec,
             make_float4(yaw[k], yaw[k + 1], yaw[k + 2], yaw[k + 3]));
      store4(lw_out, j, n, vec,
             make_float4(lw[k], lw[k + 1], lw[k + 2], lw[k + 3]));
    }
    stats_add(st, lw, x, y, yaw, idx, valid);
  }

  block_stats_row<T>(st, s_row);
  if (t == 0) {
    // The row's sums are taken at stat_shift(max), which is the max
    // wherever the max is finite.
    const float m = s_row[0];
    const float lse = m + logf(s_row[1]);
    const float lse2 = 2.0f * m + logf(s_row[2]);
    buf.lse_out[f] = lse;
    buf.lse2_out[f] = lse2;
    buf.est_out[3 * f] = s_row[3];
    buf.est_out[3 * f + 1] = s_row[4];
    buf.est_out[3 * f + 2] = s_row[5];
    const bool bad = !(isfinite(lse) && isfinite(lse2));
    const float ess = bad ? static_cast<float>(n)
                          : expf(__fsub_rn(__fmul_rn(2.0f, lse), lse2));
    buf.gate_bad[f] = bad;
    buf.gate_ess[f] = ess;
    buf.gate_fire[f] = !bad && ess < prm.ess_min;
  }
}

template <int MODE>
int launch_stats(bool fused, cudaStream_t stream, const WideBuffers& buf,
                 const WideParams& prm) {
  if (fused) {
    wide_stats_kernel<MODE, true>
        <<<prm.b, kStatsThreads, 0, stream>>>(buf, prm);
  } else {
    wide_stats_kernel<MODE, false>
        <<<prm.b, kStatsThreads, 0, stream>>>(buf, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.

// log_w: (B, n) log weights; lse, offs: (B,) float; fire: (B,) bool, all
// in filter order.  Writes src: (B,) int32 filter -> slot; fids: (B,)
// int32 slot -> filter (0 at idle slots); valid: (B,) bool; t_hi: (B, n)
// int32 boundaries in slot order, at the valid slots only.
extern "C" int tpuslam_wide_boundary(const float* log_w, const float* lse,
                                     const unsigned char* fire,
                                     const float* offs, int* t_hi, int* fids,
                                     unsigned char* valid, int* src, int n,
                                     int b, void* stream) {
  if (n < 1 || n >= (1 << 24) || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wide_boundary_kernel<<<b, kBoundThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      log_w, lse, fire, offs, t_hi, fids, valid, src, n, b);
  return static_cast<int>(cudaGetLastError());
}

// buffers: a WideBuffers, params: a WideParams template (every field but
// the key and b), both in host memory; the template stays read-only: the
// entry copies it and sets the key (seed_lo, seed_hi) and b, the filters.
// fused != 0 reads src and expanded.
extern "C" int tpuslam_wide_stats(const void* buffers, const void* params,
                                  uint32_t seed_lo, uint32_t seed_hi, int b,
                                  int mode, int fused, void* stream) {
  const WideBuffers& buf = *static_cast<const WideBuffers*>(buffers);
  WideParams p = *static_cast<const WideParams*>(params);
  p.key0 = seed_lo;
  p.key1 = seed_hi;
  p.b = b;
  if (p.n < 1 || p.n >= (1 << 24) || p.b < 1 || p.b > 65535 ||
      p.n_lm < 0 || p.n_lm > kMaxLandmarks || mode < 0 || mode > 2 ||
      (mode == 2 && buf.normals == nullptr) ||
      (fused && (buf.src == nullptr || buf.expanded == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_stats<0>(fused != 0, s, buf, p);
    case 1: return launch_stats<1>(fused != 0, s, buf, p);
    default: return launch_stats<2>(fused != 0, s, buf, p);
  }
}

// The count of K5b's warp-passes whose landmark quotients needed the IEEE
// divide (pf_math.cuh::g_div_fallbacks) on the current device, since the
// library was loaded, into *value.  Synchronises with the device: a
// check, not for the loop.
extern "C" int tpuslam_pf_wide_div_fallbacks(unsigned int* value) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      value, tpuslam::g_div_fallbacks, sizeof(unsigned int)));
}

// Resident blocks per SM of kernel `which` (0: K5a, 1: K5b fused, Philox
// mode), *name its name;
// cudaErrorInvalidValue past the last.  n is unused.
extern "C" int tpuslam_occupancy_pf_wide(int which, int n, int* blocks,
                                         const char** name) {
  (void)n;
  using tpuslam::occupancy;
  switch (which) {
    case 0:
      return occupancy(wide_boundary_kernel, "K5a wide_boundary",
                       kBoundThreads, 0, blocks, name);
    case 1:
      return occupancy(wide_stats_kernel<1, true>, "K5b wide_stats",
                       kStatsThreads, 0, blocks, name);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
