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
// space): one more grid dimension over firing slots, each slot searching
// only its own filter's boundaries.  The single-filter launch is
// unchanged.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanBlock = 1024;  // lanes per boundary block (ops: BLOCK)
constexpr int kScanWarps = kScanBlock / 32;
constexpr int kExpandBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

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

// The segmented form (the wide filter's pass B): blockIdx.y is a firing
// slot s, which expands the boundaries t_hi[s] of its filter fids[s] into
// its own output rows; an idle slot exits at once.  p and out are
// (3, b, n) with no padding; t_hi is (b, n) in slot order.
__global__ void __launch_bounds__(kExpandBlock)
expand_seg_kernel(const float* __restrict__ p, const int* __restrict__ t_hi,
                  const int* __restrict__ fids,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out, int n, int b) {
  const int s = blockIdx.y;
  if (!valid[s]) return;
  const int i = blockIdx.x * kExpandBlock + threadIdx.x;
  if (i >= n) return;
  const long long plane = static_cast<long long>(b) * n;
  const long long dst = static_cast<long long>(s) * n + i;
  const long long src = static_cast<long long>(fids[s]) * n +
                        source_of(t_hi + static_cast<long long>(s) * n, n, i);
  out[dst] = __ldg(p + src);
  out[plane + dst] = __ldg(p + plane + src);
  out[2 * plane + dst] = __ldg(p + 2 * plane + src);
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
  const dim3 grid((n + kExpandBlock - 1) / kExpandBlock, b);
  expand_seg_kernel<<<grid, kExpandBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, t_hi, fids, valid, out, n, b);
  return static_cast<int>(cudaGetLastError());
}
