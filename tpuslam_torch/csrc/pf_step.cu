// K2: the fused particle-filter step (predict + log-likelihood weight +
// the step's statistics), one launch a step.
//
// Replaces tpuslam/ops/pf_pallas.py::_pf_stats_kernel (K2b, with the
// statistics) and ::_pf_kernel (K2a, without them; the STATS template
// flag).  Each particle takes the circular step with Q noise, the five
// landmarks are moved into its frame and compared with the observation,
// and the summed log-likelihood is added to its log weight
// (particle_filter.py:156-198).  With STATS, a flag resets the incoming
// log weights to uniform (the reference's NaN->uniform reset, or the
// restart after a resample, applied in the pass) and the launch ends with
// the step's statistics written by the kernel itself:
//   stats[0:10] = [lse, lse2, x_map, y_map, yaw_map, best_lw, best index,
//                  x_est, y_est, yaw_est]
// with lse = logsumexp(lw'), lse2 = logsumexp(2 lw'), the MAP particle the
// highest flat index among the maxima (a NaN log weight never wins but
// makes the sums NaN), and x_est the MAP particle where lse is finite,
// else particle 0 (ops/pf_cuda.py::_step's rule).  The JAX package writes
// per-tile partial rows and combines them in XLA; the plain twin here does
// the same (ops/pf_cuda.py::_partial_plain, ::_combine_stats).
//
// What bounds it on an H100: the particle math.  A particle moves 32 bytes
// (12 of pose and 4 of log weight each way: 0.020 ms at 2,097,152), but
// runs a few hundred instructions (one Philox4x32-10 call, two Box-Muller
// transforms, two polynomial sincos, five landmark terms with two
// quotients by the observation std each, one exp), the same math that
// sets K4's and K5b's pace.
// So the design spends as little as it can beside that math:
//   * 256 threads a block, held to 64 registers (four blocks a SM),
//     four particles a thread (pf_math.cuh::predict_loglik_n<MODE, 4>),
//     their Philox, sincos and quotient chains independent, so the
//     scheduler interleaves them; rows read and written as float4 where
//     n % 4 == 0 and every row is 16-byte aligned, as masked scalars
//     otherwise;
//   * counter-based noise (Philox keyed by the step's seed, counter =
//     (particle index, 0, 0, 0)), so the stream does not depend on the
//     layout and no generator state is loaded or stored;
//   * running statistics a thread (stats_add), one row a block
//     (block_stats_row), and the last block to finish reduces every
//     block's row: each block writes its row to g_rows, fences and takes
//     a ticket from g_ticket; the block that takes the last ticket reads
//     the rows in index order (thread t rows t, t + T, ...; then the
//     block's fixed tree), so the result does not depend on which block
//     came last, writes stats and sets g_ticket back to 0 for the next
//     launch.  No partial rows leave the kernel and no torch op combines
//     them.
// On an H100 80GB HBM3 at 700 W, 256 threads a block beat 64, 128 and
// 512 at 2,097,152 particles (0.0557 against 0.0848, 0.0646 and 0.0738
// ms), and the 64-register hold gained 4% more (PERF.md).
// g_rows, g_first and g_ticket are one of each a device, in this
// library: two launches of K2b must not run at once on one device
// (concurrent streams would share them).  A launch on one stream after
// another always finds the ticket at 0, and so does a CUDA graph of the
// loop.
//
// The flags come from the host (PfParams::flag) or, where the caller
// gives the gate, from the device: gate = [take, restart], two bytes that
// the merge resample's K3a wrote (resample.cu), so the single filter's
// merge loop takes no host decision.  take reads the particles from
// p_alt (the resampled rows) in place of p_in, as K5b reads its expanded
// rows; restart is the flag.  Neither changes the math.
//
// Modes: 0 = noise off (builtin sinf/cosf, for parity with the plain
// path), 1 = Philox noise, 2 = caller-supplied standard normals of shape
// (3, N).  Modes 1 and 2 use the polynomial sincos.  The parameter struct
// is a __grid_constant__, so predict_loglik_n's reference to it reads the
// parameter space and nvcc makes no local copy.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "occupancy.cuh"
#include "pf_math.cuh"
#include "rows.cuh"

namespace {

using tpuslam::aligned16;
using tpuslam::block_stats_row;
using tpuslam::kMaxLandmarks;
using tpuslam::kNoiseNormals;
using tpuslam::kNoisePhilox;
using tpuslam::kPartStride;
using tpuslam::load4;
using tpuslam::philox_normals3;
using tpuslam::predict_loglik_n;
using tpuslam::stat_shift;
using tpuslam::Stats;
using tpuslam::stats_add;
using tpuslam::store4;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;               // held to 64 registers
constexpr int kPer = 4;                     // particles a thread
constexpr int kSpan = kThreads * kPer;      // particles a block
constexpr int kMaxBlocks = (1 << 24) / kSpan;
constexpr int kStatsOut = 10;               // floats of the stats output

// Host-folded constants; the layout matches ops/pf_cuda.py::_PfParams.
struct PfParams {
  long long n;
  uint32_t key0, key1;
  int n_lm;
  float flag;          // > 0: treat incoming log weights as 0 (uniform)
  float vdt, wdt;      // v*dt, w*dt (folded in double)
  float q0, q1, q2;    // q_std
  float sx, sy;        // r_std
  float inv_sx, inv_sy;  // 1 / sx, 1 / sy in float32, correctly rounded
  float log_norm;      // log(2 pi sx sy) (folded in double)
  float lm[2 * kMaxLandmarks];  // landmark (x, y) pairs
};

// Each block's statistics row of the running launch, particle 0's pose,
// and the ticket of the blocks that have written theirs.
__device__ __align__(16) float g_rows[kMaxBlocks * kPartStride];
__device__ float g_first[3];  // particle 0 of the launch (x, y, yaw)
__device__ unsigned int g_ticket = 0;

// The last block's reduction of the `g` rows: thread t takes rows t,
// t + T, ..., kTailBatch rows a pass, their loads issued together and
// read past L1 (other blocks wrote them); a pass merges its rows into the
// thread's running Stats as stats_add merges particles (the rows' sums
// are taken at stat_shift(their max), so a row's sums scale by
// exp(stat_shift(m_row) - shift) and its square).
constexpr int kTailBatch = 8;

__device__ __forceinline__ Stats rows_stats(int g) {
  Stats st;
  for (int r0 = threadIdx.x; r0 < g; r0 += kThreads * kTailBatch) {
    // A row as (m, sum, sum2, x) and (y, yaw, index, 0); none past g.
    float4 a[kTailBatch], c[kTailBatch];
#pragma unroll
    for (int k = 0; k < kTailBatch; ++k) {
      const int r = r0 + k * kThreads;
      const float4* row = reinterpret_cast<const float4*>(g_rows) + 2 * r;
      a[k] = r < g ? __ldcg(row) : make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
      c[k] = r < g ? __ldcg(row + 1) : make_float4(0.0f, 0.0f, -1.0f, 0.0f);
    }
    const float old_shift = stat_shift(st.key);
#pragma unroll
    for (int k = 0; k < kTailBatch; ++k) {
      const int idx = static_cast<int>(c[k].z);
      if (a[k].x > st.key || (a[k].x == st.key && idx > st.idx)) {
        st.key = a[k].x;
        st.idx = idx;
        st.x = a[k].w;
        st.y = c[k].x;
        st.yaw = c[k].y;
      }
    }
    const float shift = stat_shift(st.key);
    const float rs = expf(old_shift - shift);
    float sum = st.sum * rs, sum2 = st.sum2 * (rs * rs);
#pragma unroll
    for (int k = 0; k < kTailBatch; ++k) {
      const float e = expf(stat_shift(a[k].x) - shift);
      sum += a[k].y * e;
      sum2 += a[k].z * (e * e);
    }
    st.sum = sum;
    st.sum2 = sum2;
  }
  return st;
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pf_step_kernel(const float* __restrict__ p_in,
               const float* __restrict__ lw_in, const float* __restrict__ z,
               const float* __restrict__ normals, float* __restrict__ p_out,
               float* __restrict__ lw_out, float* __restrict__ stats,
               const unsigned char* __restrict__ gate,
               const float* __restrict__ p_alt,
               const __grid_constant__ PfParams prm) {
  constexpr int P = kPer;
  __shared__ float s_row[kPartStride];
  __shared__ bool s_last;
  const int n = static_cast<int>(prm.n);
  const int t = threadIdx.x;
  const int j = blockIdx.x * kSpan + P * t;
  bool reset = STATS && prm.flag > 0.0f;
  if (STATS && gate != nullptr) {
    reset = gate[1] != 0;
    if (gate[0] != 0) p_in = p_alt;
  }
  const bool vec = (n & 3) == 0 && aligned16(p_in) && aligned16(lw_in) &&
                   aligned16(p_out) && aligned16(lw_out) &&
                   (MODE != kNoiseNormals || aligned16(normals));

  float x[P], y[P], yaw[P], lw[P], n0[P], n1[P], n2[P], acc[P];
  int idx[P];
  bool valid[P];
  {
    const float4 a = load4(p_in, j, n, vec);
    const float4 b = load4(p_in + n, j, n, vec);
    const float4 c = load4(p_in + 2 * n, j, n, vec);
    const float4 d = reset ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                           : load4(lw_in, j, n, vec);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    y[0] = b.x; y[1] = b.y; y[2] = b.z; y[3] = b.w;
    yaw[0] = c.x; yaw[1] = c.y; yaw[2] = c.z; yaw[3] = c.w;
    lw[0] = d.x; lw[1] = d.y; lw[2] = d.z; lw[3] = d.w;
    if (MODE == kNoiseNormals) {
      const float4 g = load4(normals, j, n, vec);
      const float4 h = load4(normals + n, j, n, vec);
      const float4 q = load4(normals + 2 * n, j, n, vec);
      n0[0] = g.x; n0[1] = g.y; n0[2] = g.z; n0[3] = g.w;
      n1[0] = h.x; n1[1] = h.y; n1[2] = h.z; n1[3] = h.w;
      n2[0] = q.x; n2[1] = q.y; n2[2] = q.z; n2[3] = q.w;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    idx[k] = j + k;
    valid[k] = j + k < n;
    if (MODE == kNoisePhilox) {
      philox_normals3(static_cast<uint32_t>(j + k), 0u, prm.key0, prm.key1,
                      n0[k], n1[k], n2[k]);
    } else if (MODE != kNoiseNormals) {
      n0[k] = n1[k] = n2[k] = 0.0f;
    }
  }
  predict_loglik_n<MODE, P>(x, y, yaw, n0, n1, n2, prm, z, valid, acc);
#pragma unroll
  for (int k = 0; k < P; ++k) lw[k] = lw[k] + acc[k];
  store4(p_out, j, n, vec, make_float4(x[0], x[1], x[2], x[3]));
  store4(p_out + n, j, n, vec, make_float4(y[0], y[1], y[2], y[3]));
  store4(p_out + 2 * n, j, n, vec, make_float4(yaw[0], yaw[1], yaw[2],
                                               yaw[3]));
  store4(lw_out, j, n, vec, make_float4(lw[0], lw[1], lw[2], lw[3]));
  if (!STATS) return;

  Stats st;
  stats_add(st, lw, x, y, yaw, idx, valid);
  block_stats_row<kThreads>(st, s_row);
  if (t < kPartStride) {
    g_rows[blockIdx.x * kPartStride + t] = s_row[t];
    if (blockIdx.x == 0 && t == 0) {  // particle 0, the estimate's fallback
      g_first[0] = x[0];
      g_first[1] = y[0];
      g_first[2] = yaw[0];
    }
    // The row (and particle 0) reach the device before the ticket is
    // taken, so the last block sees every row.  Only these threads fence:
    // the last block reads nothing else that this block wrote.
    __threadfence();
  }
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  __threadfence();
  block_stats_row<kThreads>(rows_stats(static_cast<int>(gridDim.x)),
                            s_row);
  if (t == 0) {
    // The row's sums are taken at stat_shift(max), which is the max
    // wherever the max is finite.
    const float m = s_row[0];
    const float lse = m + logf(s_row[1]);
    stats[0] = lse;
    stats[1] = 2.0f * m + logf(s_row[2]);
    stats[2] = s_row[3];
    stats[3] = s_row[4];
    stats[4] = s_row[5];
    stats[5] = m;
    stats[6] = s_row[6];
    // All-NaN weights reset to uniform, whose argmax is particle 0.
    const bool finite = isfinite(lse);
    stats[7] = finite ? s_row[3] : __ldcg(g_first);
    stats[8] = finite ? s_row[4] : __ldcg(g_first + 1);
    stats[9] = finite ? s_row[5] : __ldcg(g_first + 2);
    g_ticket = 0;  // every block has taken its ticket
  }
}

template <int MODE>
void launch(bool with_stats, unsigned grid, cudaStream_t stream,
            const float* p_in, const float* lw_in, const float* z,
            const float* normals, float* p_out, float* lw_out, float* stats,
            const unsigned char* gate, const float* p_alt,
            const PfParams& prm) {
  if (with_stats) {
    pf_step_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(
        p_in, lw_in, z, normals, p_out, lw_out, stats, gate, p_alt, prm);
  } else {
    pf_step_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(
        p_in, lw_in, z, normals, p_out, lw_out, stats, gate, p_alt, prm);
  }
}

}  // namespace

// C entry point for ctypes.  p_in/p_out: (3, n) rows; lw_in/lw_out: (n,);
// z: (n_lm, 2) observation on the device; normals: (3, n) in mode 2, else
// unused; stats: (10,) when with_stats (the layout above); gate: null (the
// flag from `flag`) or two bytes [take, restart] on the device, with
// p_alt: (3, n) the rows taken where take is set (with_stats only).
// `params` is a filled template (every field but the key and the flag),
// which stays read-only: the entry copies it and sets the key (seed_lo,
// seed_hi) and `flag`.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.
extern "C" int tpuslam_pf_step(const float* p_in, const float* lw_in,
                               const float* z, const float* normals,
                               float* p_out, float* lw_out, float* stats,
                               const void* params, uint32_t seed_lo,
                               uint32_t seed_hi, float flag, int mode,
                               int with_stats, const unsigned char* gate,
                               const float* p_alt, void* stream) {
  PfParams p = *static_cast<const PfParams*>(params);
  p.key0 = seed_lo;
  p.key1 = seed_hi;
  p.flag = flag;
  if (p.n < 1 || p.n >= (1LL << 24) || p.n_lm < 0 ||
      p.n_lm > kMaxLandmarks || mode < 0 || mode > 2 ||
      (mode == 2 && normals == nullptr) ||
      (with_stats && stats == nullptr) ||
      (gate != nullptr && (!with_stats || p_alt == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((p.n + kSpan - 1) / kSpan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = with_stats != 0;
  switch (mode) {
    case 0: launch<0>(st, grid, s, p_in, lw_in, z, normals, p_out, lw_out, stats, gate, p_alt, p); break;
    case 1: launch<1>(st, grid, s, p_in, lw_in, z, normals, p_out, lw_out, stats, gate, p_alt, p); break;
    default: launch<2>(st, grid, s, p_in, lw_in, z, normals, p_out, lw_out, stats, gate, p_alt, p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The ticket counter of the current device into *value (0 between
// launches).  Synchronises with the device: a check, not for the loop.
extern "C" int tpuslam_pf_step_ticket(unsigned int* value) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(value, g_ticket, sizeof(unsigned int)));
}

// The count of K2b's warp-passes whose landmark quotients needed the IEEE
// divide (pf_math.cuh::g_div_fallbacks) on the current device, since the
// library was loaded, into *value.  Synchronises with the device: a
// check, not for the loop.
extern "C" int tpuslam_pf_step_div_fallbacks(unsigned int* value) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      value, tpuslam::g_div_fallbacks, sizeof(unsigned int)));
}

// Resident blocks per SM of kernel `which` (0: K2b, 1: K2a, Philox mode),
// *name its name; cudaErrorInvalidValue past the last.  n is unused.
extern "C" int tpuslam_occupancy_pf_step(int which, int n, int* blocks,
                                         const char** name) {
  (void)n;
  switch (which) {
    case 0:
      return tpuslam::occupancy(pf_step_kernel<1, true>, "K2b pf_step",
                                kThreads, 0, blocks, name);
    case 1:
      return tpuslam::occupancy(pf_step_kernel<1, false>, "K2a pf_step",
                                kThreads, 0, blocks, name);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
