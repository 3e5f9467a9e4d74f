// K3: the systematic merge resample, as prefix -> boundary -> slots -> copy.
//
// Replaces tpuslam/ops/resample_pallas.py's pass 1
// (_boundary_compact_seg_kernel and _boundary_compact_kernel: exact
// in-tile prefix of the quantized weights, the slot-boundary law, survivor
// compaction) and pass 2 (_expand_kernel: survivors expanded into their
// output slots).
//
// The selection law: particle j owns the output slots [t_{j-1}, t_j) with
// t_j = clip(ceil(n * (cum_j * inv_tot) - offs), 0, n) and t_{n-1} forced
// to n, where cum is the exact-integer prefix of the weights quantized to
// multiples of 2^-20 of their float total, and inv_tot = 1 / q_tot, the
// reciprocal of the quantized total.
//
// Pass 1 (K3a) takes the weights themselves (the public merge), or the
// single filter's log weights and their normalizers with its ESS gate
// (the fused rollout's step), and computes everything from there: no
// torch op runs before it.  Its work has two grid-wide dependencies: the
// float total of the weights before any lane quantizes, and q_tot, the
// sum of the quantized integers, before any boundary.  A grid has no
// order, so K3a is one cooperative launch (every block resident at once,
// at most eight 256-thread blocks an SM, each looping over tiles) in three
// passes over the row (the second and third read it again, from L2 at the
// sizes the path runs: 8 MB at 2,097,152 particles), with a grid barrier
// after the first two; the last block to arrive at a barrier runs the
// pass's tail before it releases the others:
//   1. sum: each 1024-lane tile's weights w_j (or expf(lw_j - lse), IEEE
//      subtract) summed in a fixed order: a thread's four lanes in
//      sequence, then a tree of halving IEEE adds over the block's 256
//      threads (level h: v[i] + v[i + h]); the tile sums go to g_part.  The
//      tail adds them in a fixed order too (thread t: tiles t, t + 256, ...
//      in sequence from 0, then the same tree) and writes scale =
//      2^20 / total (__fdiv_rn).  ops/resample_cuda.py::
//      boundary_total_plain repeats every add, so twin and kernel agree
//      bit for bit;
//   2. quant: wq_j = rintf(w_j * scale) (half to even, as
//      quantize_weights_law), each tile's integer sum to g_base; the tail
//      turns g_base into its exclusive prefix in place (integer sums are
//      exact in any order) and writes inv_tot = __frcp_rn(q_tot), the
//      twin's IEEE 1 / x;
//   3. law: the tile's quantized weights again, their exact in-block
//      prefix plus g_base[tile] gives cum, and the boundary law runs with
//      __fmul_rn / __fsub_rn, so nvcc cannot contract it into an FMA and
//      the boundaries equal the plain version's bit for bit; lanes from
//      n - 1 on get n.
// With the gate, every block computes it from the two device normalizers
// (bad = !(isfinite(lse) && isfinite(lse2)), ess = bad ? n :
// expf(2 lse - lse2), fire = ess < ess_min, the threshold rounded to
// float32 as torch rounds the scalar), block 0 writes gate = [fire,
// bad | fire], and where it is off every block exits before the first
// barrier, so no host reads the gate and an idle step costs one launch.
// On an H100 80GB HBM3 at 700 W the one launch took as long as three
// launches with last-block tickets firing and a third of their time idle
// (PERF.md).  The scratch (g_part, g_base, the two scalars and the
// barrier's counters) is one of each a device, in this library: two K3a
// launches must not run at once on one device (concurrent streams would
// share them).  A launch after another on one stream finds the barrier's
// arrivals at 0.
//
// What bounds K3a on an H100: bytes, 8 a lane (4 of weight read, 4 of
// boundary written: 0.0050 ms at 2,097,152); the design reads the row
// three times, the last two from L2, and waits at two grid barriers.
//
// Pass 2 (K3b): the survivors expanded into their output slots, in one of
// two designs, which the launch takes by its slot count.  Both give each
// thread runs of four consecutive output slots: the run's first source
// comes from a binary search of boundaries staged in shared memory, and
// since sources do not decrease each following slot probes the previous
// source and the next one, and searches only past them; a run's three
// planes are stored as float4s where the row is aligned and the run
// whole, so a warp writes 512 contiguous bytes a plane; an idle slot's
// blocks exit after one load.  Bytes: 12 a slot read and 12 written, 4 a
// lane of boundary.
//   * The single filter (expand_range_kernel, one slot: valid[0] the
//     gate's fire flag, or 1 for the public merge): its output slots are
//     cut into ranges of kRangeSlots, one block a range, so every block
//     writes the same number of slots however the weight is spread (a
//     block a window of particles left a particle that takes a quarter of
//     2,097,152 slots to one block: 0.18 ms against 0.028 on an H100
//     80GB HBM3).  The range's sources are a run of particles [j0, j1):
//     warps 0 and 1 find the sources of its first and last slot, the
//     first j with t[j] > i, by a 32-way search of the row (32 lanes
//     probe a range at once: five dependent loads at 2^21 boundaries);
//     the block stages t[j0, j1) where it fits (kRangeStage boundaries;
//     dense survivors), else every step-th of them (survivors sparser
//     than a slot in two particles), and a slot's source then lies within
//     a step of the first sample above it, which a short search of global
//     memory finds.  The row stride is n_pad: lanes [n, n_pad) are
//     written 0 where the slot is valid.
//   * The wide batched filter's pass B (expand_seg_kernel, B slots;
//     pf_batch_pallas.py:1367-1387, which ran _expand_kernel in slot
//     space): each firing slot expands its own filter's boundaries.  A
//     slot's row is cut into windows of kSegWindow boundaries, one block a
//     window and slot; the window's particles own the output slots
//     [t[w0 - 1], t[w1 - 1]), which two loads give, so no window searches
//     global memory, and the block stages its window with 16-byte loads
//     where the row is aligned.  Windows with no output slot (every
//     weight zero) exit after three loads.  The grid is (ceil(n /
//     kSegWindow), b): at 1024 x 10,000, 5 blocks a slot.  The range
//     design's searches cost this launch about 4% on an H100 80GB HBM3
//     (0.0320 against 0.0308 ms at 240 firing of 1024 x 10,000), where a
//     row of 10,000 slots spreads over five blocks however its weight
//     lies, so the wide path keeps the window.
//
// The merge's pass2="compressed" form runs pass 2 through a survivor stack,
// which two more kernels build and read; the single filter is one slot
// of their launches (its valid[0] the gate's fire flag, as for K3b).  The
// stack has the rows' own width: stack block k (1024 lanes) holds its
// survivors, the lanes j with t_j > t_{j-1} (t_{-1} = 0), in its leading
// cnt[k] columns, each with its values and its slot interval [t_lo, t_hi)
// = [t_{j-1}, t_j), and inert columns after them (zero values, the empty
// interval at the block's last boundary t_run(k)).  So the stack's t_hi
// row is sorted, the first column above any slot is a survivor, and block
// k's survivors own exactly the output slots [t_run(k - 1), t_run(k)).
//   * compact (K3c, replaces _compact_kernel, resample_pallas.py:203):
//     256 threads a block, four lanes a thread (one int4 of boundaries
//     where the row is aligned), t_{j-1} from the neighbouring lane by a
//     shuffle, the survivors' values loaded before one block-wide scan of
//     the threads' survivor counts; the survivors' values and intervals
//     are staged in shared memory and every column of the stack block is
//     written once, four a thread, as float4 and int4 stores where the
//     stack is aligned.  One slot (the single
//     filter) takes a CUDA block a stack block; B slots take kCompactWindow
//     stack blocks a CUDA block in turn, so an idle slot's blocks are few
//     and write only its zero counts.  A block holds at most 1024
//     survivors, so no cap can overflow.  Bytes: 4 a lane read, 12 a
//     survivor read, 20 a column written.
//   * expand_compressed (K3d, replaces _expand_compressed_kernel,
//     resample_pallas.py:489): output slot i takes the first stack column
//     with t_hi > i and copies its three floats from the stack.  The TPU
//     gathered every block's survivors into one list first (in XLA); here
//     the per-block stack is read as it stands, with its counts.  Two
//     designs, taken by the launch's slot count as K3b's are; both stage
//     the live columns they need (t_hi, t_lo and the column; the inert
//     tails skipped) in shared memory and write runs of four consecutive
//     output slots a thread (expand_staged), a survivor's values kept in
//     registers while slots share it, float4 stores where the row is
//     aligned.  Each survivor's staged t_lo <= its first slot is asserted
//     (the partition check; a device assert traps).
//     - The single filter (compressed_range_kernel): a block a range of
//       kRangeSlots output slots, as the single K3b; warps 0 and 1 find
//       the survivors of its first and last slot by a 32-way search of
//       the t_hi row (five dependent loads at 2^21), and the survivors
//       between, at most kRangeSlots since each owns a slot of the range,
//       are staged.  An idle launch is n / kRangeSlots blocks that read one
//       byte.
//     - The wide filter's pass B (compressed_window_kernel): a block a
//       window of kStackWindow stack blocks and a slot, as the segmented
//       K3b; its output slots [t_run(k0 - 1), t_run(k1)) come from two
//       loads, so no window searches global memory.
//     Bytes: 20 a survivor read, 12 a slot written.
// The TPU's bf16 splits, one-hot products, t_k / w_b caps, skip table and
// fallback have no counterpart here.

#include <cuda_runtime.h>

#include <algorithm>
#include <cassert>
#include <cstdint>

#include "occupancy.cuh"
#include "pf_math.cuh"  // aligned16
#include "rows.cuh"      // block_exclusive_scan, load4_of, store4_of

namespace {

using tpuslam::aligned16;
using tpuslam::block_exclusive_scan;
using tpuslam::kFullMask;
using tpuslam::load4;
using tpuslam::load4_of;
using tpuslam::store4_of;

constexpr int kScanBlock = 1024;  // lanes per stack block (ops: BLOCK)
constexpr int kCompactThreads = 256;  // K3c's threads, four lanes each
constexpr int kCompactWindow = 2;  // the segmented K3c's stack blocks a block
constexpr int kStackWindow = 2;    // the segmented K3d's stack blocks a block
constexpr int kSegBlock = 256;     // K3b's and K3d's threads a block
constexpr int kRangeSlots = 2048;  // the single form's output slots a block
constexpr int kRangeStage = 4096;  // its staged boundaries, 16 KB
constexpr int kSegWindow = 2048;   // the segmented form's boundaries a block
constexpr int kBoundThreads = 256;  // K3a's threads a block
constexpr int kTile = 4 * kBoundThreads;  // K3a's lanes a tile
constexpr int kMaxTiles = (1 << 24) / kTile;
constexpr int kBoundBlocksPerSm = 8;  // K3a's grid: 2048 threads an SM
static_assert(4 * kCompactThreads == kScanBlock &&
                  4 * kSegBlock == kScanBlock,
              "K3c and the segmented K3d take four columns a thread");

// K3a's scratch (see the file's head): each tile's weight sum, each tile's
// quantized sum and then its exclusive prefix, scale = 2^20 / total,
// inv_tot = 1 / q_tot, and its grid barrier's arrivals and generation.
__device__ float g_part[kMaxTiles];
__device__ int g_base[kMaxTiles];
__device__ float g_scale;
__device__ float g_inv;
__device__ unsigned int g_arrive;
__device__ unsigned int g_gen;

// The single filter's ESS gate from its two normalizers (see the head).
__device__ __forceinline__ void ess_gate(const float* lse_p,
                                         const float* lse2_p, float ess_min,
                                         int n, bool& fire, bool& bad) {
  const float lse = __ldg(lse_p);
  const float lse2 = __ldg(lse2_p);
  bad = !(isfinite(lse) && isfinite(lse2));
  const float ess = bad ? static_cast<float>(n)
                        : expf(__fsub_rn(__fmul_rn(2.0f, lse), lse2));
  fire = ess < ess_min;
}

// The weights of four lanes from j on: the row itself (LOG false) or
// expf(lw - lse); 0 from n on.
template <bool LOG>
__device__ __forceinline__ float4 weights4(const float* row, int j, int n,
                                           bool vec, float lse) {
  const float4 v = load4(row, j, n, vec);
  if (!LOG) return v;
  return make_float4(j < n ? expf(__fsub_rn(v.x, lse)) : 0.0f,
                     j + 1 < n ? expf(__fsub_rn(v.y, lse)) : 0.0f,
                     j + 2 < n ? expf(__fsub_rn(v.z, lse)) : 0.0f,
                     j + 3 < n ? expf(__fsub_rn(v.w, lse)) : 0.0f);
}

__device__ __forceinline__ int quantize(float w, float scale) {
  return static_cast<int>(rintf(__fmul_rn(w, scale)));
}

// The block's sum of one float a thread in a fixed order: a tree of
// halving IEEE adds (level h: v[i] + v[i + h]), the last five levels by
// warp shuffles.  Every thread must call it; every thread gets the sum.
__device__ __forceinline__ float block_tree_sum(float v, float* s) {
  constexpr int T = kBoundThreads;
  const int t = threadIdx.x;
  s[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = T / 2; h >= 32; h >>= 1) {
    if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
    __syncthreads();
  }
  if (t < 32) {
    float w = s[t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      w = __fadd_rn(w, __shfl_down_sync(kFullMask, w, d));
    }
    if (t == 0) s[0] = w;
  }
  __syncthreads();
  const float sum = s[0];
  __syncthreads();  // s is free for the next call
  return sum;
}

// A grid-wide barrier of a cooperative launch (every block resident):
// each block waits until all have arrived; the last to arrive first runs
// `tail` with all its threads (one block's work between two passes), then
// releases the others by a new generation.  g_arrive returns to 0.
template <class F>
__device__ __forceinline__ void grid_barrier(bool* s_last, F tail) {
  __syncthreads();
  unsigned int gen = 0;
  if (threadIdx.x == 0) {
    gen = *reinterpret_cast<volatile unsigned int*>(&g_gen);
    __threadfence();
    *s_last = atomicAdd(&g_arrive, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (*s_last) {
    __threadfence();
    tail();
    __syncthreads();
    if (threadIdx.x == 0) {
      g_arrive = 0;
      __threadfence();
      atomicAdd(&g_gen, 1u);
    }
  } else if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile unsigned int*>(&g_gen) == gen) {
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// K3a, one cooperative launch (see the file's head).  With LOG, row holds
// log weights and the gate is computed and written here.
template <bool LOG>
__global__ void __launch_bounds__(kBoundThreads)
boundary_kernel(const float* __restrict__ row,
                const float* __restrict__ lse_p,
                const float* __restrict__ lse2_p, float ess_min,
                unsigned char* __restrict__ gate,
                const float* __restrict__ offs_p, int* __restrict__ t_hi,
                int n, int n_pad) {
  constexpr int T = kBoundThreads;
  __shared__ float s_sum[T];
  __shared__ int s_warp[T / 32];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  float lse = 0.0f;
  if (LOG) {
    bool fire, bad;
    ess_gate(lse_p, lse2_p, ess_min, n, fire, bad);
    if (blockIdx.x == 0 && t == 0) {
      gate[0] = fire;
      gate[1] = fire || bad;
    }
    if (!fire) return;  // the whole grid: the gate is off
    lse = __ldg(lse_p);
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int tiles_pad = (n_pad + kTile - 1) / kTile;
  const bool vec = (n & 3) == 0 && aligned16(row);

  // 1. The tiles' weight sums, then the total and the scale.
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const float4 w = weights4<LOG>(row, tile * kTile + 4 * t, n, vec, lse);
    const float sum = block_tree_sum(
        __fadd_rn(__fadd_rn(__fadd_rn(w.x, w.y), w.z), w.w), s_sum);
    if (t == 0) g_part[tile] = sum;
  }
  grid_barrier(&s_last, [&] {
    float acc = 0.0f;
    for (int r = t; r < tiles; r += T) acc = __fadd_rn(acc, __ldcg(g_part + r));
    const float total = block_tree_sum(acc, s_sum);
    if (t == 0) g_scale = __fdiv_rn(1048576.0f, total);
  });
  const float scale = __ldcg(&g_scale);

  // 2. The tiles' quantized sums, then their exclusive prefix and 1 / q_tot
  // (thread t of the last block takes a run of tiles).
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const float4 w = weights4<LOG>(row, tile * kTile + 4 * t, n, vec, lse);
    int total;
    block_exclusive_scan<T>(quantize(w.x, scale) + quantize(w.y, scale) +
                                quantize(w.z, scale) + quantize(w.w, scale),
                            s_warp, total);
    if (t == 0) g_base[tile] = total;
  }
  grid_barrier(&s_last, [&] {
    const int per = (tiles + T - 1) / T;
    const int lo = min(t * per, tiles);
    const int hi = min(lo + per, tiles);
    int run = 0;
    for (int r = lo; r < hi; ++r) run += __ldcg(g_base + r);
    int q_tot;
    int pre = block_exclusive_scan<T>(run, s_warp, q_tot);
    for (int r = lo; r < hi; ++r) {
      const int v = __ldcg(g_base + r);
      g_base[r] = pre;
      pre += v;
    }
    if (t == 0) g_inv = __frcp_rn(static_cast<float>(q_tot));
  });
  const float inv_tot = __ldcg(&g_inv);

  // 3. The boundaries of t_hi's n_pad lanes; the tiles past n hold only
  // forced lanes.
  const float offs = __ldg(offs_p);
  const float nf = static_cast<float>(n);
  const bool vec_out = (n_pad & 3) == 0 && aligned16(t_hi);
  for (int tile = blockIdx.x; tile < tiles_pad; tile += gridDim.x) {
    const int j = tile * kTile + 4 * t;
    int c[4] = {0, 0, 0, 0};  // the thread's inclusive prefix
    if (tile < tiles) {
      const float4 w = weights4<LOG>(row, j, n, vec, lse);
      c[0] = quantize(w.x, scale);
      c[1] = c[0] + quantize(w.y, scale);
      c[2] = c[1] + quantize(w.z, scale);
      c[3] = c[2] + quantize(w.w, scale);
    }
    int total;
    const int pre = (tile < tiles ? __ldcg(g_base + tile) : 0) +
                    block_exclusive_scan<T>(c[3], s_warp, total);
    int tb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float scaled = __fmul_rn(
          nf, __fmul_rn(static_cast<float>(pre + c[k]), inv_tot));
      float v = ceilf(__fsub_rn(scaled, offs));
      v = fminf(fmaxf(v, 0.0f), nf);
      if (j + k >= n - 1) v = nf;  // the last particle takes the rest
      tb[k] = static_cast<int>(v);
    }
    store4_of(t_hi, j, n_pad, vec_out, make_int4(tb[0], tb[1], tb[2], tb[3]));
  }
}

// The first j in [lo, hi) with t[j] > i, or hi; t sorted.
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

// The first j in [0, n) with t[j] > i, by one warp: each round the 32
// lanes probe 32 evenly spaced lanes of the range left and keep the gap
// after the last probe at or below i, so a row of 2^21 takes five
// dependent loads.  t[n - 1] > i; every lane gets the answer.
__device__ __forceinline__ int warp_first_above(const int* t, int n, int i) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n - 1;  // the answer lies in [lo, hi], t[hi] > i
  while (hi - lo > 31) {
    const int step = (hi - lo + 31) >> 5;
    const bool above = __ldg(t + min(lo + lane * step, hi)) > i;
    const unsigned mask = __ballot_sync(kFullMask, above);
    if (mask == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(mask) - 1;
      hi = min(lo + f * step, hi);
      if (f > 0) lo += (f - 1) * step + 1;
    }
  }
  const bool above = lo + lane >= hi || __ldg(t + lo + lane) > i;
  return lo + __ffs(__ballot_sync(kFullMask, above)) - 1;
}

// The single K3b's runs of four output slots of [i0, i1), whose sources
// are the particles [0, m) of tg (the row's boundaries) and src (its rows,
// planes `plane` apart), with ts holding every boundary (SPARSE false) or
// every step-th, ms of them (SPARSE: a slot's source then lies within a step of
// the first sample above it, which a short search of global memory
// finds).  Sources do not decrease, so after a run's first slot each slot
// probes the previous source and the next one, and searches only past
// them.
template <bool SPARSE>
__device__ __forceinline__ void expand_runs(
    const int* ts, int ms, int step, const int* __restrict__ tg, int m,
    const float* __restrict__ src, long long plane, float* dst, int i0,
    int i1, bool aligned) {
  // The first j in [0, m) with tg[j] > i (tg[m - 1] > i).
  auto source = [&](int i) {
    const int q = first_above(ts, 0, ms, i);
    if (!SPARSE) return q;
    const int lo = q == 0 ? 0 : (q - 1) * step + 1;
    return first_above(tg, lo, min(q * step, m - 1), i);
  };
  auto t_at = [&](int j) { return SPARSE ? __ldg(tg + j) : ts[j]; };
  for (int i = i0 + 4 * threadIdx.x; i < i1; i += 4 * kSegBlock) {
    int j = source(i);
    float x[4], y[4], z[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u < i1) {
        if (u > 0 && t_at(j) <= i + u) {  // past the previous source
          ++j;
          if (t_at(j) <= i + u) j = source(i + u);
        }
        x[u] = __ldg(src + j);
        y[u] = __ldg(src + plane + j);
        z[u] = __ldg(src + 2 * plane + j);
      }
    }
    if (aligned && i + 4 <= i1) {
      reinterpret_cast<float4*>(dst + i)[0] =
          make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(dst + plane + i)[0] =
          make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(dst + 2 * plane + i)[0] =
          make_float4(z[0], z[1], z[2], z[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u < i1) {
          dst[i + u] = x[u];
          dst[plane + i + u] = y[u];
          dst[2 * plane + i + u] = z[u];
        }
      }
    }
  }
}

// K3b of the single filter: block c writes the output slots [i0, i1) =
// [c, c + 1) * kRangeSlots of the row from its boundaries t, where
// valid[0] (else it exits at once).  p and out are (3, stride), t
// (stride,), with n <= stride particles; lanes [n, stride) are written 0.
__global__ void __launch_bounds__(kSegBlock)
expand_range_kernel(const float* __restrict__ p, const int* __restrict__ t,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ out, int n, int stride) {
  __shared__ int ts[kRangeStage];
  __shared__ int s_src[2];
  if (!valid[0]) return;
  const long long plane = stride;
  if (blockIdx.x == gridDim.x - 1) {  // the padding lanes, if any
    for (int i = n + threadIdx.x; i < stride; i += kSegBlock) {
      out[i] = 0.0f;
      out[plane + i] = 0.0f;
      out[2 * plane + i] = 0.0f;
    }
  }
  const int i0 = blockIdx.x * kRangeSlots;
  const int i1 = min(n, i0 + kRangeSlots);
  // The sources of the first and the last slot: warps 0 and 1.
  if (threadIdx.x < 64) {
    const int j = warp_first_above(t, n, threadIdx.x < 32 ? i0 : i1 - 1);
    if ((threadIdx.x & 31) == 0) s_src[threadIdx.x >> 5] = j;
  }
  __syncthreads();
  const int j0 = s_src[0];
  const int m = s_src[1] + 1 - j0;  // the block's sources: [j0, j0 + m)
  // Their boundaries staged: every one where they fit, else every
  // step-th (survivors sparse).
  const int* tg = t + j0;
  const int step = (m + kRangeStage - 1) / kRangeStage;
  const int ms = (m + step - 1) / step;
  for (int q = threadIdx.x; q < ms; q += kSegBlock) {
    ts[q] = __ldg(tg + q * step);
  }
  __syncthreads();
  const float* src = p + j0;
  const bool aligned = (stride & 3) == 0 && aligned16(out);
  if (step == 1) {
    expand_runs<false>(ts, ms, step, tg, m, src, plane, out, i0, i1,
                       aligned);
  } else {
    expand_runs<true>(ts, ms, step, tg, m, src, plane, out, i0, i1,
                      aligned);
  }
}

// K3b in segments (the wide filter's pass B): block (c, s) expands the
// particles [w0, w1) = [c, c + 1) * kSegWindow of slot s's filter fids[s]
// by the boundaries t_hi[s] into its output slots; an idle slot exits at
// once.  p and out are (3, b, n) with no padding; t_hi is (b, n) in slot
// order.
__global__ void __launch_bounds__(kSegBlock)
expand_seg_kernel(const float* __restrict__ p, const int* __restrict__ t_hi,
                  const int* __restrict__ fids,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out, int n, int b) {
  __shared__ __align__(16) int ts[kSegWindow];
  const int s = blockIdx.y;
  if (!valid[s]) return;
  const int w0 = blockIdx.x * kSegWindow;
  const int len = min(kSegWindow, n - w0);
  const int* t = t_hi + static_cast<long long>(s) * n + w0;
  // The window's output slots [a, e): a slot's source is the first j with
  // t[j] > i, and t[n - 1] = n.
  const int a = w0 == 0 ? 0 : __ldg(t - 1);
  const int e = __ldg(t + len - 1);
  if (a == e) return;
  // Rows and windows 16-byte aligned: n % 4 == 0 and both bases aligned
  // (a contiguous view may start at any 4-byte offset).
  const bool aligned = (n & 3) == 0 && aligned16(t_hi) && aligned16(out);
  if (aligned) {
    const int4* t4 = reinterpret_cast<const int4*>(t);
    for (int q = threadIdx.x; q < (len >> 2); q += kSegBlock) {
      reinterpret_cast<int4*>(ts)[q] = __ldg(t4 + q);
    }
  } else {
    for (int q = threadIdx.x; q < len; q += kSegBlock) ts[q] = __ldg(t + q);
  }
  __syncthreads();
  const long long plane = static_cast<long long>(b) * n;
  const float* src = p + static_cast<long long>(fids[s]) * n + w0;
  float* dst = out + static_cast<long long>(s) * n;
  for (int r = (a >> 2) + threadIdx.x; 4 * r < e; r += kSegBlock) {
    const int i0 = 4 * r;
    int j = first_above(ts, 0, len, max(i0, a));
    float x[4], y[4], z[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      if (i >= a && i < e) {
        if (ts[j] <= i) {  // past the previous source: the next, or search
          ++j;
          if (ts[j] <= i) j = first_above(ts, j + 1, len, i);
        }
        x[u] = __ldg(src + j);
        y[u] = __ldg(src + plane + j);
        z[u] = __ldg(src + 2 * plane + j);
      }
    }
    if (aligned && i0 >= a && i0 + 4 <= e) {
      reinterpret_cast<float4*>(dst + i0)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(dst + plane + i0)[0] =
          make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(dst + 2 * plane + i0)[0] =
          make_float4(z[0], z[1], z[2], z[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= a && i < e) {
          dst[i] = x[u];
          dst[plane + i] = y[u];
          dst[2 * plane + i] = z[u];
        }
      }
    }
  }
}

// K3c: stack blocks [k0, k0 + per) of slot s = blockIdx.y, k0 =
// blockIdx.x * per, each in turn: it compacts the particles of the slot's
// filter fids[s] by its boundaries t_hi[s] into row s of the (3, b, len) /
// (2, b, len) stack (t_lo, then t_hi a plane on) and row s of the (b,
// nblk) counts; an idle slot writes its blocks' zero counts and exits at
// once.  p is (3, b, len): filter f's particles at f.  Thread t takes the
// stack block's lanes 4t .. 4t + 3 (one int4 where the row is aligned),
// t_{j-1} of its first lane from the thread before by a shuffle (a warp's
// first thread loads it); one block-wide scan of its survivor count places
// them; the block's columns are staged in shared memory and written once
// each, four a thread, as float4 / int4 stores where the stack is aligned.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const float* __restrict__ p, const int* __restrict__ t_hi,
               const int* __restrict__ fids,
               const unsigned char* __restrict__ valid,
               float* __restrict__ vals, int* __restrict__ iv,
               int* __restrict__ cnt, int len, int b, int per) {
  constexpr int T = kCompactThreads;
  __shared__ __align__(16) float s_v[3][kScanBlock];
  __shared__ __align__(16) int s_iv[2][kScanBlock];
  __shared__ int s_warp[T / 32];
  __shared__ int s_run;
  const int s = blockIdx.y;
  const int nblk = (len + kScanBlock - 1) / kScanBlock;
  const int k0 = blockIdx.x * per;
  const int k1 = min(nblk, k0 + per);
  int* c = cnt + static_cast<long long>(s) * nblk;
  if (!valid[s]) {
    for (int k = k0 + threadIdx.x; k < k1; k += T) c[k] = 0;
    return;
  }
  // Rows 16-byte aligned: len % 4 == 0 and the bases aligned.
  const bool vec_in = (len & 3) == 0 && aligned16(t_hi);
  const bool vec_out = (len & 3) == 0 && aligned16(vals) && aligned16(iv);
  const long long plane = static_cast<long long>(b) * len;
  const long long row = static_cast<long long>(s) * len;
  const int* t = t_hi + row;
  p += static_cast<long long>(fids[s]) * len;
  vals += row;
  iv += row;
  const int lane = threadIdx.x & 31;
  const int q = 4 * threadIdx.x;  // the thread's first lane and column
  for (int k = k0; k < k1; ++k) {
    const int col0 = k * kScanBlock;
    const int j = col0 + q;
    const int last = min(len, col0 + kScanBlock) - 1;  // the block's last lane
    const int4 tv = load4_of<int4>(t, j, len, vec_in);
    int prev = __shfl_up_sync(kFullMask, tv.w, 1);
    if (lane == 0) prev = j > 0 && j - 1 < len ? __ldg(t + j - 1) : 0;
    const int tl[4] = {tv.x, tv.y, tv.z, tv.w};
    bool f[4];
    int num = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      f[u] = j + u <= last && tl[u] > (u == 0 ? prev : tl[u - 1]);
      num += f[u];
    }
    if (j <= last && last < j + 4) s_run = tl[last - j];
    // The survivors' values, loaded before the scan so their latency
    // overlaps it (only theirs: where the wide filter fires, about 6% of
    // the lanes survive).
    float pv[3][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (f[u]) {
        pv[0][u] = __ldg(p + j + u);
        pv[1][u] = __ldg(p + plane + j + u);
        pv[2][u] = __ldg(p + 2 * plane + j + u);
      }
    }
    int count;
    int pos = block_exclusive_scan<T>(num, s_warp, count);
    if (threadIdx.x == 0) c[k] = count;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (f[u]) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          s_v[r][pos] = pv[r][u];
        }
        s_iv[0][pos] = u == 0 ? prev : tl[u - 1];
        s_iv[1][pos] = tl[u];
        ++pos;
      }
    }
    __syncthreads();
    // Columns q .. q + 3: a survivor's below the count, else inert (zero
    // values, the empty interval at the block's last boundary).
    if (j <= last) {
      const bool live[4] = {q < count, q + 1 < count, q + 2 < count,
                            q + 3 < count};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(&s_v[r][q]);
        store4_of(vals + r * plane, j, len, vec_out,
                  make_float4(live[0] ? v.x : 0.0f, live[1] ? v.y : 0.0f,
                              live[2] ? v.z : 0.0f, live[3] ? v.w : 0.0f));
      }
      const int run = s_run;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int4 w = *reinterpret_cast<const int4*>(&s_iv[r][q]);
        store4_of(iv + r * plane, j, len, vec_out,
                  make_int4(live[0] ? w.x : run, live[1] ? w.y : run,
                            live[2] ? w.z : run, live[3] ? w.w : run));
      }
    }
    __syncthreads();  // the staging and s_run are free for the next block
  }
}

// The single K3d's staging: the live stack columns from ca to cb (the
// survivors of a range's first and last slot) of one stack row (lo and hi
// its t_lo and t_hi rows, c its counts), in order, their t_hi, t_lo and
// column to s_hi, s_lo and s_col; returns how many.  Block k of those
// spanned holds its columns [max(ca, k * 1024), min(cb + 1, k * 1024 +
// c[k])).  The blocks go 256 at a time, one a thread (a range can span
// many blocks with no survivor): a block-wide scan of their live counts
// places them, then thread t stages the columns t, t + 256, ... of the
// chunk, each finding its block by a search of the placed offsets.  A
// stack that partitions the slots never stages more than `cap` (a
// survivor owns at least one slot of the range); more traps.  Every
// thread must call it.
__device__ int stage_live(const int* __restrict__ lo,
                          const int* __restrict__ hi,
                          const int* __restrict__ c, int ca, int cb,
                          int cap, int* s_hi, int* s_lo, int* s_col,
                          int* s_from, int* s_pos, int* s_warp) {
  constexpr int T = kSegBlock;
  const int k0 = ca / kScanBlock;
  const int k1 = cb / kScanBlock;
  int base = 0;
  for (int kc = k0; kc <= k1; kc += T) {
    const int k = kc + threadIdx.x;
    int from = 0;
    int num = 0;
    if (k <= k1) {
      from = max(ca, k * kScanBlock);
      num = max(min(cb + 1, k * kScanBlock + __ldg(c + k)) - from, 0);
    }
    int total;
    const int pos = base + block_exclusive_scan<T>(num, s_warp, total);
    s_from[threadIdx.x] = from;
    s_pos[threadIdx.x] = pos;
    __syncthreads();
    assert(base + total <= cap);  // the survivors partition the slots
    const int runs = min(T, k1 - kc + 1);
    for (int r = threadIdx.x; r < total && base + r < cap; r += T) {
      const int x = base + r;
      const int blk = first_above(s_pos, 0, runs, x) - 1;
      const int col = s_from[blk] + (x - s_pos[blk]);
      s_hi[x] = __ldg(hi + col);
      s_lo[x] = __ldg(lo + col);
      s_col[x] = col;
    }
    base += total;
    __syncthreads();
  }
  return min(base, cap);
}

// K3d's output slots [a, e) of one row from the m staged survivors (s_hi
// sorted: a slot's survivor is the first above it), their values read
// from the stack row src (planes `plane` apart) at s_col: runs of four
// consecutive slots a thread, aligned to the row; each slot after a run's
// first probes the previous survivor and the next one and searches only
// past them, and a survivor's values stay in registers while slots share
// it.  Each survivor's interval must hold its first slot (the partition
// check).  Stores float4s where `aligned` and the run is whole.
__device__ __forceinline__ void expand_staged(
    const int* s_hi, const int* s_lo, const int* s_col, int m,
    const float* __restrict__ src, long long plane, float* dst, int a,
    int e, bool aligned) {
  for (int r = (a >> 2) + threadIdx.x; 4 * r < e; r += kSegBlock) {
    const int i0 = 4 * r;
    int j = -1;
    float xv = 0.0f, yv = 0.0f, zv = 0.0f;
    float x[4], y[4], z[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      x[u] = y[u] = z[u] = 0.0f;
      if (i >= a && i < e) {
        if (j < 0 || s_hi[j] <= i) {
          if (j < 0) {
            j = first_above(s_hi, 0, m, i);
          } else if (++j < m && s_hi[j] <= i) {
            j = first_above(s_hi, j + 1, m, i);
          }
          assert(j < m && s_lo[j] <= i);  // the interval holds slot i
          const int col = s_col[j];
          xv = __ldg(src + col);
          yv = __ldg(src + plane + col);
          zv = __ldg(src + 2 * plane + col);
        }
        x[u] = xv;
        y[u] = yv;
        z[u] = zv;
      }
    }
    if (aligned && i0 >= a && i0 + 4 <= e) {
      reinterpret_cast<float4*>(dst + i0)[0] =
          make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(dst + plane + i0)[0] =
          make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(dst + 2 * plane + i0)[0] =
          make_float4(z[0], z[1], z[2], z[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= a && i < e) {
          dst[i] = x[u];
          dst[plane + i] = y[u];
          dst[2 * plane + i] = z[u];
        }
      }
    }
  }
}

// K3d of the single filter: block c writes the output slots [i0, i1) =
// [c, c + 1) * kRangeSlots of the row from its stack (cv: (3, len), civ:
// (2, len), cnt: (nblk,)) where valid[0] (else it exits at once); lanes
// [n, len) are written 0.  Warps 0 and 1 find the survivors of the first
// and the last slot, the first stack columns with t_hi above them, by a
// 32-way search of the t_hi row (sorted, and t_hi[n - 1] = n); the
// survivors between them, at most kRangeSlots, are staged, the inert
// columns skipped.
__global__ void __launch_bounds__(kSegBlock)
compressed_range_kernel(const float* __restrict__ cv,
                        const int* __restrict__ civ,
                        const int* __restrict__ cnt,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ out, int n, int len) {
  __shared__ int s_hi[kRangeSlots], s_lo[kRangeSlots], s_col[kRangeSlots];
  __shared__ int s_from[kSegBlock], s_pos[kSegBlock];
  __shared__ int s_warp[kSegBlock / 32];
  __shared__ int s_src[2];
  if (!valid[0]) return;
  const long long plane = len;
  if (blockIdx.x == gridDim.x - 1) {  // the padding lanes, if any
    for (int i = n + threadIdx.x; i < len; i += kSegBlock) {
      out[i] = 0.0f;
      out[plane + i] = 0.0f;
      out[2 * plane + i] = 0.0f;
    }
  }
  const int i0 = blockIdx.x * kRangeSlots;
  const int i1 = min(n, i0 + kRangeSlots);
  const int* hi = civ + plane;
  if (threadIdx.x < 64) {
    const int col = warp_first_above(hi, n, threadIdx.x < 32 ? i0 : i1 - 1);
    if ((threadIdx.x & 31) == 0) s_src[threadIdx.x >> 5] = col;
  }
  __syncthreads();
  const int ca = s_src[0];
  const int cb = s_src[1];
  const int m = stage_live(civ, hi, cnt, ca, cb, kRangeSlots, s_hi, s_lo,
                           s_col, s_from, s_pos, s_warp);
  const bool aligned = (len & 3) == 0 && aligned16(out);
  expand_staged(s_hi, s_lo, s_col, m, cv, plane, out, i0, i1, aligned);
}

// K3d in segments (the wide filter's pass B): block (c, s) expands the
// stack blocks [k0, k1] = [c, c + 1) * kStackWindow of slot s's stack row
// (cv: (3, b, n), civ: (2, b, n), cnt: (b, nblk)) into row s of out; an
// idle slot exits at once.  The window's survivors own the output slots
// [t_run(k0 - 1), t_run(k1)), t_run(k) the last t_hi of block k (0 before
// block 0), which two loads give, so no window searches global memory.
// Those loads, the counts and the window's columns go out at once, and
// the live ones (cnt[k] a block) are staged; a window with no output slot
// exits when they arrive.
__global__ void __launch_bounds__(kSegBlock)
compressed_window_kernel(const float* __restrict__ cv,
                         const int* __restrict__ civ,
                         const int* __restrict__ cnt,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ out, int n, int b) {
  constexpr int W = kStackWindow;
  __shared__ int s_hi[W * kScanBlock], s_lo[W * kScanBlock];
  __shared__ int s_col[W * kScanBlock];
  const int s = blockIdx.y;
  if (!valid[s]) return;
  const int nblk = (n + kScanBlock - 1) / kScanBlock;
  const int k0 = blockIdx.x * W;
  const int k1 = min(nblk, k0 + W) - 1;
  const long long plane = static_cast<long long>(b) * n;
  const long long row = static_cast<long long>(s) * n;
  const int* lo = civ + row;
  const int* hi = civ + plane + row;
  const int* c = cnt + static_cast<long long>(s) * nblk;
  // Everything the window reads before its expand, at once: its output
  // range, its counts, and four columns of t_hi and t_lo a thread from
  // each of its blocks (an int4 each where the stack is aligned; zeros
  // past the row).
  const bool vec = (n & 3) == 0 && aligned16(civ);
  const int a = k0 == 0 ? 0 : __ldg(hi + k0 * kScanBlock - 1);
  const int e = __ldg(hi + min(n, (k1 + 1) * kScanBlock) - 1);
  int num[W];
  int4 h[W], l[W];
  const int q = 4 * threadIdx.x;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    num[w] = k0 + w <= k1 ? min(max(__ldg(c + k0 + w), 0), kScanBlock) : 0;
    h[w] = load4_of<int4>(hi, (k0 + w) * kScanBlock + q, n, vec);
    l[w] = load4_of<int4>(lo, (k0 + w) * kScanBlock + q, n, vec);
  }
  if (a == e) return;
  // The live columns (each block's first num[w]) staged in order.
  int m = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int hv[4] = {h[w].x, h[w].y, h[w].z, h[w].w};
    const int lv[4] = {l[w].x, l[w].y, l[w].z, l[w].w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q + u < num[w]) {
        s_hi[m + q + u] = hv[u];
        s_lo[m + q + u] = lv[u];
        s_col[m + q + u] = (k0 + w) * kScanBlock + q + u;
      }
    }
    m += num[w];
  }
  __syncthreads();
  const bool aligned = (n & 3) == 0 && aligned16(out);
  expand_staged(s_hi, s_lo, s_col, m, cv + row, plane, out + row, a, e,
                aligned);
}

}  // namespace

// C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.

namespace {

// K3a's cooperative launch: the row's tiles, at most kBoundBlocksPerSm
// blocks an SM and no more than the SMs hold at once (the launch refuses
// a grid that would not be resident).
template <bool LOG>
int launch_boundary(const float* row, const float* lse, const float* lse2,
                    float ess_min, const float* offs, unsigned char* gate,
                    int* t_hi, int n, int n_pad, cudaStream_t stream) {
  static int per_sm = 0;  // the same on every H100
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, boundary_kernel<LOG>, kBoundThreads, 0);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (n_pad + kTile - 1) / kTile;
  const int grid = std::max(
      1, std::min(tiles, std::min(per_sm, kBoundBlocksPerSm) * sms));
  void* args[] = {&row, &lse, &lse2, &ess_min, &gate, &offs, &t_hi, &n,
                  &n_pad};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(boundary_kernel<LOG>), dim3(grid),
      dim3(kBoundThreads), args, 0, stream));
}

}  // namespace

// K3a, one cooperative launch.  row: (n_pad,) weights, padding lanes
// ignored; or,
// with lse given, the log weights, lse and lse2 their normalizers (one
// float each on the device), ess_min the gate's threshold, and gate: (2,)
// bytes written [fire, bad | fire] (the launches do nothing more where
// fire is 0).  offs: the comb offset on the device.  Writes t_hi: (n_pad,)
// int32.
extern "C" int tpuslam_resample_boundary(const float* row, const float* lse,
                                         const float* lse2, float ess_min,
                                         const float* offs,
                                         unsigned char* gate, int* t_hi,
                                         int n, int n_pad, void* stream) {
  if (n < 1 || n_pad < n || n_pad >= (1 << 24) ||
      (lse != nullptr && (lse2 == nullptr || gate == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr) {
    return launch_boundary<true>(row, lse, lse2, ess_min, offs, gate, t_hi,
                                 n, n_pad, s);
  }
  return launch_boundary<false>(row, nullptr, nullptr, 0.0f, offs, nullptr,
                                t_hi, n, n_pad, s);
}

// K3b of one filter: p: (3, n_pad) rows; t_hi: (n_pad,) from K3a; valid:
// one byte on the device (the gate's fire flag, or 1).  Writes out:
// (3, n_pad), the resampled rows, padding lanes zero, where valid[0].
extern "C" int tpuslam_resample_expand(const float* p, const int* t_hi,
                                       const unsigned char* valid,
                                       float* out, int n, int n_pad,
                                       void* stream) {
  if (n < 1 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + kRangeSlots - 1) / kRangeSlots;
  expand_range_kernel<<<grid, kSegBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, t_hi, valid, out, n, n_pad);
  return static_cast<int>(cudaGetLastError());
}

// K3b in segments: p: (3, b, n) particle rows of b filters; t_hi: (b, n)
// boundaries in slot order; fids, valid: (b,) each slot's filter and
// whether it fires.  Writes out: (3, b, n), slot s's resampled rows at s,
// valid slots only.
extern "C" int tpuslam_resample_expand_seg(const float* p, const int* t_hi,
                                           const int* fids,
                                           const unsigned char* valid,
                                           float* out, int n, int b,
                                           void* stream) {
  if (n < 1 || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kSegWindow - 1) / kSegWindow, b);
  expand_seg_kernel<<<grid, kSegBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, t_hi, fids, valid, out, n, b);
  return static_cast<int>(cudaGetLastError());
}

// K3a's barrier arrivals on the current device into *value (0 between
// launches).  Synchronises with the device: a check, not for the loop.
extern "C" int tpuslam_resample_arrivals(unsigned int* value) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(value, g_arrive, sizeof(unsigned int)));
}

// p: (3, b, len) particle rows of b filters; t_hi: (b, len) boundaries in
// slot order; fids, valid: (b,).  Writes the valid slots' rows of vals:
// (3, b, len) and iv: (2, b, len), and cnt: (b, ceil(len / 1024)), zero
// for idle slots.  One slot (the single filter) takes a CUDA block a stack
// block; more take kCompactWindow stack blocks a CUDA block, so an idle
// slot's blocks are few.
extern "C" int tpuslam_resample_compact(const float* p, const int* t_hi,
                                        const int* fids,
                                        const unsigned char* valid,
                                        float* vals, int* iv, int* cnt,
                                        int len, int b, void* stream) {
  if (len < 1 || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nblk = (len + kScanBlock - 1) / kScanBlock;
  const int per = b == 1 ? 1 : kCompactWindow;
  const dim3 grid((nblk + per - 1) / per, b);
  compact_kernel<<<grid, kCompactThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      p, t_hi, fids, valid, vals, iv, cnt, len, b, per);
  return static_cast<int>(cudaGetLastError());
}

// cv: (3, b, len), civ: (2, b, len), cnt: (b, ceil(len / 1024)) each
// slot's stack from the compaction; valid: (b,).  Writes the valid slots'
// rows of out: (3, b, len), lanes from n on zero.  One slot (the single
// filter) takes a block a range of output slots; more take a block a
// window of stack blocks and a slot, and need n == len.
extern "C" int tpuslam_resample_expand_compressed(const float* cv,
                                                  const int* civ,
                                                  const int* cnt,
                                                  const unsigned char* valid,
                                                  float* out, int n, int len,
                                                  int b, void* stream) {
  if (n < 1 || len < n || b < 1 || b > 65535 || (b > 1 && n != len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 1) {
    const int grid = (n + kRangeSlots - 1) / kRangeSlots;
    compressed_range_kernel<<<grid, kSegBlock, 0, st>>>(cv, civ, cnt, valid,
                                                        out, n, len);
  } else {
    const int nblk = (n + kScanBlock - 1) / kScanBlock;
    const dim3 grid((nblk + kStackWindow - 1) / kStackWindow, b);
    compressed_window_kernel<<<grid, kSegBlock, 0, st>>>(cv, civ, cnt, valid,
                                                         out, n, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of kernel `which` (0: K3a in the gated form, 1:
// K3b of the single filter, 2: K3b in segments, 3: K3c, 4: K3d of the
// single filter, 5: K3d in segments), *name its name;
// cudaErrorInvalidValue past the last.
// n is unused.
extern "C" int tpuslam_occupancy_resample(int which, int n, int* blocks,
                                          const char** name) {
  (void)n;
  using tpuslam::occupancy;
  switch (which) {
    case 0:
      return occupancy(boundary_kernel<true>, "K3a boundary", kBoundThreads,
                       0, blocks, name);
    case 1:
      return occupancy(expand_range_kernel, "K3b expand_range", kSegBlock, 0,
                       blocks, name);
    case 2:
      return occupancy(expand_seg_kernel, "K3b expand_seg", kSegBlock, 0,
                       blocks, name);
    case 3:
      return occupancy(compact_kernel, "K3c compact", kCompactThreads, 0,
                       blocks, name);
    case 4:
      return occupancy(compressed_range_kernel, "K3d compressed_range",
                       kSegBlock, 0, blocks, name);
    case 5:
      return occupancy(compressed_window_kernel, "K3d compressed_window",
                       kSegBlock, 0, blocks, name);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
