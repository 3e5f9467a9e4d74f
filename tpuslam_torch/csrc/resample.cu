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
// multiples of 2^-20 of their total.  The quantized weights wq, the
// per-block exclusive bases and inv_tot = 1 / q_tot are computed once by
// plain torch outside the kernels (ops/resample_cuda.py), as XLA computed
// them around the TPU kernels, so kernel and plain version consume the
// same integers.
//
// What bounds it on an H100: bytes.  Pass 1 reads 4 bytes of wq and
// writes 4 bytes of t a lane; pass 2 reads the 12 bytes of the selected
// particle and writes 12 bytes a slot, with a binary search over t that
// the 50 MB L2 holds at the sizes the path runs (8 MB at 2,097,152
// particles).  Arithmetic is a few dozen integer and float operations a
// lane.  So the design is plain coalesced loads and stores:
//   * pass 1: one block of 1024 threads per 1024-lane block; an exact
//     int32 warp-shuffle prefix plus the block's base gives cum (integers
//     below 2^24 convert to float exactly); the boundary law runs with
//     __fmul_rn / __fsub_rn, so nvcc cannot contract it into an FMA and
//     the boundaries equal the plain version's bit for bit;
//   * pass 2: one thread per output slot finds its source, the first j
//     with t_j > i (t is non-decreasing and t_{n-1} = n), and copies the
//     three float32 values, so the values are bit-exact by construction.
// The TPU's static caps (survivors per tile, window blocks per output
// tile), its bf16 three-way splits for one-hot matmuls and its XLA
// fallback have no counterpart: every weight profile, dense or a single
// survivor, takes the same two launches.
//
// Pass 2 also has a segmented form for the wide batched filter (its pass
// B, pf_batch_pallas.py:1367-1387, which ran _expand_kernel in slot
// space): each firing slot expands its own filter's boundaries.  A slot's
// row is cut into windows of kSegWindow boundaries, one block a window
// and slot; the window's particles own the output slots
// [t[w0 - 1], t[w1 - 1]), which two loads give, so no window searches
// global memory:
//   * the block stages its window of t once, with coalesced 16-byte loads
//     where the row is 16-byte aligned (n % 4 == 0 and an aligned base),
//     into shared memory;
//   * each thread owns runs of four consecutive output slots; the run's
//     first source comes from a binary search of the staged window, and
//     since sources do not decrease each following slot probes the
//     previous source and the next one, and searches only past them;
//   * a run's three planes are stored as float4s where the row is aligned
//     and the run whole, so a warp writes 512 contiguous bytes a plane;
//   * an idle slot's blocks, and windows with no output slot (every
//     weight zero), exit after one or three loads.  The grid is
//     (ceil(n / kSegWindow), b): at 1024 x 10,000, 5 blocks a slot, so
//     the idle slots' blocks cost a few microseconds a launch.
// A row of any length runs: a longer row has more windows.  The
// single-filter launch (expand_kernel) keeps one thread a slot and its
// search of the whole row.
//
// The merge's pass2="compressed" form runs pass 2 through a survivor stack,
// which two more kernels build and read; each serves the single filter as one
// slot of its segmented form (the wide filter's pass B), blockIdx.y being
// the slot:
//   * compact (K3c, replaces _compact_kernel, resample_pallas.py:203):
//     per 1024-lane block, an exact int32 warp-shuffle scan of the
//     survivor flags t_j > t_{j-1} (t_{-1} = 0; a block's first lane
//     reads the last boundary of the block before) moves each survivor's
//     three floats and its slot interval [t_{j-1}, t_j) to column
//     block * 1024 + rank.  Columns past the block's count get zero values
//     and an empty interval at the block's last boundary, so no output
//     slot can select them; cnt[block] is the count.  A block holds at
//     most 1024 survivors, so the stack has the rows' own width and no
//     cap can overflow.  Bytes: 8 a lane read (t_j, and t_{j-1} from L1),
//     12 a survivor read, 20 a column written.
//   * expand_compressed (K3d, replaces _expand_compressed_kernel,
//     resample_pallas.py:489): output slot i takes the first stack column
//     with t_hi > i and copies its three floats from the stack.  The TPU
//     gathered every block's survivors into one list first (in XLA); here
//     the per-block stack is searched as it stands, because its t_hi row
//     is already sorted: survivors' t_hi rise strictly, and an inert
//     column repeats the last boundary before it, so the first column
//     above i is always a survivor, never an inert one.  That removes the
//     gather, its survivor count and any host read of it: done in torch
//     over every lane, the gather took ten times the two kernels' time on
//     an H100 on the wide path.  The survivor's t_lo <= i is asserted.
//     Bytes: 20 a survivor read, 12 a slot written.
// The TPU's bf16 splits, one-hot products, t_k / w_b caps, skip table and
// fallback have no counterpart here.

#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

#include "occupancy.cuh"
#include "pf_math.cuh"  // aligned16
#include "rows.cuh"      // warp_inclusive_scan

namespace {

using tpuslam::warp_inclusive_scan;

constexpr int kScanBlock = 1024;  // lanes per boundary block (ops: BLOCK)
constexpr int kScanWarps = kScanBlock / 32;
constexpr int kExpandBlock = 256;
constexpr int kSegBlock = 256;     // the segmented expand's threads
constexpr int kSegWindow = 2048;   // its boundaries a block, 8 KB staged

__global__ void __launch_bounds__(kScanBlock)
boundary_kernel(const float* __restrict__ wq, const float* __restrict__ base,
                const float* __restrict__ inv_tot_p,
                const float* __restrict__ offs_p, int* __restrict__ t_hi,
                int n, int n_pad) {
  __shared__ int warp_sums[kScanWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kScanBlock + threadIdx.x;
  const int v = j < n_pad ? __float2int_rn(wq[j]) : 0;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
  __syncthreads();
  if (j >= n_pad) return;
  const int cum = __float2int_rn(base[blockIdx.x]) +
                  (warp > 0 ? warp_sums[warp - 1] : 0) + incl;
  const float nf = static_cast<float>(n);
  const float scaled = __fmul_rn(nf, __fmul_rn(static_cast<float>(cum),
                                               *inv_tot_p));
  float t = ceilf(__fsub_rn(scaled, *offs_p));
  t = fminf(fmaxf(t, 0.0f), nf);
  if (j >= n - 1) t = nf;  // the last particle takes every remaining slot
  t_hi[j] = static_cast<int>(t);
}

// The source of output slot i: the first j with t[j] > i (t is
// non-decreasing and t[n-1] = n > i).
__device__ __forceinline__ int source_of(const int* __restrict__ t, int n,
                                         int i) {
  int lo = 0;
  int hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t + mid) > i) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kExpandBlock)
expand_kernel(const float* __restrict__ p, const int* __restrict__ t_hi,
              float* __restrict__ out, int n, int n_pad) {
  const int i = blockIdx.x * kExpandBlock + threadIdx.x;
  if (i >= n_pad) return;
  if (i >= n) {
    out[i] = 0.0f;
    out[n_pad + i] = 0.0f;
    out[2 * n_pad + i] = 0.0f;
    return;
  }
  const int lo = source_of(t_hi, n, i);
  out[i] = __ldg(p + lo);
  out[n_pad + i] = __ldg(p + n_pad + lo);
  out[2 * n_pad + i] = __ldg(p + 2 * n_pad + lo);
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

// The segmented form (the wide filter's pass B): block (c, s) expands the
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
  const bool aligned = (n & 3) == 0 && tpuslam::aligned16(t_hi) &&
                       tpuslam::aligned16(out);
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

// K3c: block blockIdx.x of slot s = blockIdx.y, which compacts the
// particles of its filter fids[s] by its boundaries t_hi[s] into row s of
// the (3, b, len) / (2, b, len) stack (t_lo, then t_hi a plane on) and
// row s of the (b, nblk) counts; an idle slot writes zero counts and exits
// at once.  p is (3, b, len): filter f's particles at f.
__global__ void __launch_bounds__(kScanBlock)
compact_kernel(const float* __restrict__ p, const int* __restrict__ t_hi,
               const int* __restrict__ fids,
               const unsigned char* __restrict__ valid,
               float* __restrict__ vals, int* __restrict__ iv,
               int* __restrict__ cnt, int len, int b) {
  __shared__ int warp_sums[kScanWarps];
  const int s = blockIdx.y;
  if (!valid[s]) {
    if (threadIdx.x == 0) cnt[s * gridDim.x + blockIdx.x] = 0;
    return;
  }
  const long long plane = static_cast<long long>(b) * len;
  const long long row = static_cast<long long>(s) * len;
  const int* t = t_hi + row;
  p += static_cast<long long>(fids[s]) * len;
  vals += row;
  iv += row;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kScanBlock;
  const int j = col0 + threadIdx.x;
  const bool in = j < len;
  const int t_j = in ? __ldg(t + j) : 0;
  const int t_prev = (in && j > 0) ? __ldg(t + j - 1) : 0;
  const int f = t_j > t_prev ? 1 : 0;
  const int incl = warp_inclusive_scan(f, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
  __syncthreads();
  const int count = warp_sums[kScanWarps - 1];
  if (threadIdx.x == 0) cnt[s * gridDim.x + blockIdx.x] = count;
  if (!in) return;
  if (f) {
    const int col = col0 + (warp > 0 ? warp_sums[warp - 1] : 0) + incl - 1;
    vals[col] = __ldg(p + j);
    vals[plane + col] = __ldg(p + plane + j);
    vals[2 * plane + col] = __ldg(p + 2 * plane + j);
    iv[col] = t_prev;
    iv[plane + col] = t_j;
  }
  if (static_cast<int>(threadIdx.x) >= count) {
    const int t_run = __ldg(t + min(len, col0 + kScanBlock) - 1);
    vals[j] = 0.0f;
    vals[plane + j] = 0.0f;
    vals[2 * plane + j] = 0.0f;
    iv[j] = t_run;
    iv[plane + j] = t_run;
  }
}

// K3d: slot s = blockIdx.y expands its own stack row (cv: (3, b, len),
// civ: (2, b, len)) into row s of out: slot i < n takes the first column k
// with t_hi[k] > i (a survivor, and k <= n - 1, see above) and copies its
// values; slots n <= i < len are 0; an idle slot exits at once.
__global__ void __launch_bounds__(kExpandBlock)
expand_compressed_kernel(const float* __restrict__ cv,
                         const int* __restrict__ civ,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ out, int n, int len, int b) {
  const int s = blockIdx.y;
  if (!valid[s]) return;
  const int i = blockIdx.x * kExpandBlock + threadIdx.x;
  if (i >= len) return;
  const long long plane = static_cast<long long>(b) * len;
  const long long row = static_cast<long long>(s) * len;
  if (i >= n) {
    out[row + i] = 0.0f;
    out[plane + row + i] = 0.0f;
    out[2 * plane + row + i] = 0.0f;
    return;
  }
  const long long src = row + source_of(civ + plane + row, n, i);
  assert(__ldg(civ + src) <= i);  // the survivor's interval holds slot i
  out[row + i] = __ldg(cv + src);
  out[plane + row + i] = __ldg(cv + plane + src);
  out[2 * plane + row + i] = __ldg(cv + 2 * plane + src);
}

}  // namespace

// C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.

// wq: (n_pad,) quantized weights; base: (ceil(n_pad / 1024),) exclusive
// block prefixes; inv_tot, offs: one float each, on the device.
// Writes t_hi: (n_pad,) int32.
extern "C" int tpuslam_resample_boundary(const float* wq, const float* base,
                                         const float* inv_tot,
                                         const float* offs, int* t_hi, int n,
                                         int n_pad, void* stream) {
  if (n < 1 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n_pad + kScanBlock - 1) /
                                              kScanBlock);
  boundary_kernel<<<grid, kScanBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      wq, base, inv_tot, offs, t_hi, n, n_pad);
  return static_cast<int>(cudaGetLastError());
}

// p: (3, n_pad) particle rows; t_hi from the boundary pass.  Writes out:
// (3, n_pad), the resampled rows, padding lanes zero.
extern "C" int tpuslam_resample_expand(const float* p, const int* t_hi,
                                       float* out, int n, int n_pad,
                                       void* stream) {
  if (n < 1 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n_pad + kExpandBlock - 1) /
                                              kExpandBlock);
  expand_kernel<<<grid, kExpandBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, t_hi, out, n, n_pad);
  return static_cast<int>(cudaGetLastError());
}

// p: (3, b, n) particle rows of b filters; t_hi: (b, n) boundaries in slot
// order; fids, valid: (b,) each slot's filter and whether it fires.
// Writes out: (3, b, n), slot s's resampled rows at s, valid slots only.
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

// p: (3, b, len) particle rows of b filters; t_hi: (b, len) boundaries in
// slot order; fids, valid: (b,).  Writes the valid slots' rows of vals:
// (3, b, len) and iv: (2, b, len), and cnt: (b, ceil(len / 1024)), zero
// for idle slots.
extern "C" int tpuslam_resample_compact(const float* p, const int* t_hi,
                                        const int* fids,
                                        const unsigned char* valid,
                                        float* vals, int* iv, int* cnt,
                                        int len, int b, void* stream) {
  if (len < 1 || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((len + kScanBlock - 1) / kScanBlock, b);
  compact_kernel<<<grid, kScanBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, t_hi, fids, valid, vals, iv, cnt, len, b);
  return static_cast<int>(cudaGetLastError());
}

// cv: (3, b, len), civ: (2, b, len) each slot's stack from the compaction;
// valid: (b,).  Writes the valid slots' rows of out: (3, b, len), lanes
// from n on zero.
extern "C" int tpuslam_resample_expand_compressed(const float* cv,
                                                  const int* civ,
                                                  const unsigned char* valid,
                                                  float* out, int n, int len,
                                                  int b, void* stream) {
  if (n < 1 || len < n || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((len + kExpandBlock - 1) / kExpandBlock, b);
  expand_compressed_kernel<<<grid, kExpandBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      cv, civ, valid, out, n, len, b);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of kernel `which` (0: boundary, 1: expand, 2: the
// segmented expand, 3: compact, 4: the compressed expand), *name its name;
// cudaErrorInvalidValue past the last.  n is unused.
extern "C" int tpuslam_occupancy_resample(int which, int n, int* blocks,
                                          const char** name) {
  (void)n;
  using tpuslam::occupancy;
  switch (which) {
    case 0:
      return occupancy(boundary_kernel, "K3a boundary", kScanBlock, 0,
                       blocks, name);
    case 1:
      return occupancy(expand_kernel, "K3b expand", kExpandBlock, 0, blocks,
                       name);
    case 2:
      return occupancy(expand_seg_kernel, "K3b expand_seg", kSegBlock, 0,
                       blocks, name);
    case 3:
      return occupancy(compact_kernel, "K3c compact", kScanBlock, 0, blocks,
                       name);
    case 4:
      return occupancy(expand_compressed_kernel, "K3d expand_compressed",
                       kExpandBlock, 0, blocks, name);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
