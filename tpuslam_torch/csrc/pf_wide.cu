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
//   torch:  the ESS gate from the carried (B,) normalizers; the firing
//           filters compacted into slots (fids, valid); the quantized
//           weights of every filter and their exact inclusive prefix cum
//           (torch.cumsum of integers below 2^24, exact in any order);
//           inv_tot = 1 / q_tot and the comb offset of each slot.  The JAX
//           package computes these in XLA outside its kernels.
//   K5a:    per (slot, 256 lanes): the boundary law and forcing of
//           tile_boundary_compact (resample_pallas.py:709-728) on the
//           slot's filter's prefix, t_hi written per lane in slot order.
//           Idle slots exit at once.
//   K3b:    per (slot, 256 output lanes): each slot's output particle i
//           copies the first particle j of its filter with t_hi[j] > i.
//   K5b:    per (filter, 256 lanes): on fire[f] the particles come from
//           the expanded rows of slot src[f] and the log weights restart
//           at 0 (the JAX fused form); where bad & !fire they reset to 0;
//           then predict, the landmark log-likelihood and one partial row
//           a block for ops/pf_batch_cuda.py::_combine_wide_stats.
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
// What bounds them on an H100: bytes.  K5a reads 4 bytes of prefix and
// writes 4 bytes of boundary a lane of a firing filter; K5b reads and
// writes 16 bytes a particle (from the expanded rows on a firing filter)
// with K2's few hundred operations a particle.  So: one thread a lane,
// coalesced rows, the reductions in shared memory and warp shuffles.
//
// Noise (K5b): 0 = off (builtin trig), 1 = Philox keyed by the step's seed
// with counter (particle, filter, 0, 0), as K4, 2 = caller-supplied
// normals (3, B, n).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "pf_math.cuh"

namespace {

using tpuslam::block_partial_row;
using tpuslam::kNoiseNormals;
using tpuslam::kNoisePhilox;
using tpuslam::kPartStride;
using tpuslam::philox_normals3;
using tpuslam::predict_loglik;

constexpr int kBlock = 256;
constexpr int kMaxLandmarks = 8;

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
  float log_norm;      // log(2 pi sx sy) (folded in double)
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
  float* parts;                 // (B, ceil(n / 256), 8)
};

__global__ void __launch_bounds__(kBlock)
wide_boundary_kernel(const float* __restrict__ cum,
                     const int* __restrict__ fids,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ inv_tot,
                     const float* __restrict__ offs, int* __restrict__ t_hi,
                     int n) {
  const int s = blockIdx.y;
  if (!valid[s]) return;  // an idle slot
  const int j = blockIdx.x * kBlock + threadIdx.x;
  if (j >= n) return;
  const float c = cum[static_cast<long long>(fids[s]) * n + j];
  const float nf = static_cast<float>(n);
  const float scaled = __fmul_rn(nf, __fmul_rn(c, inv_tot[s]));
  float t = ceilf(__fsub_rn(scaled, offs[s]));
  t = fminf(fmaxf(t, 0.0f), nf);
  if (j >= n - 1) t = nf;  // the last particle takes every remaining slot
  t_hi[static_cast<long long>(s) * n + j] = static_cast<int>(t);
}

template <int MODE, bool FUSED>
__global__ void __launch_bounds__(kBlock)
wide_stats_kernel(const WideBuffers buf, const WideParams prm) {
  const int n = prm.n;
  const int f = blockIdx.y;
  const int j = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = j < n;
  const long long row = static_cast<long long>(f) * n;
  const long long plane = static_cast<long long>(prm.b) * n;
  float x = 0.0f, y = 0.0f, yaw = 0.0f, lw = -INFINITY;
  if (valid) {
    const bool fire = buf.fire[f] != 0;
    float lw0;
    if (FUSED && fire) {
      const long long e = static_cast<long long>(buf.src[f]) * n + j;
      x = buf.expanded[e];
      y = buf.expanded[plane + e];
      yaw = buf.expanded[2 * plane + e];
      lw0 = 0.0f;  // the uniform restart after a resample
    } else {
      x = buf.p_in[row + j];
      y = buf.p_in[plane + row + j];
      yaw = buf.p_in[2 * plane + row + j];
      lw0 = buf.lw_in[row + j];
    }
    if (buf.bad[f] != 0 && !fire) lw0 = 0.0f;  // the NaN -> uniform reset
    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
    if (MODE == kNoisePhilox) {
      philox_normals3(static_cast<uint32_t>(j), static_cast<uint32_t>(f),
                      prm.key0, prm.key1, n0, n1, n2);
    } else if (MODE == kNoiseNormals) {
      n0 = buf.normals[row + j];
      n1 = buf.normals[plane + row + j];
      n2 = buf.normals[2 * plane + row + j];
    }
    lw = lw0 + predict_loglik<MODE>(
                   x, y, yaw, n0, n1, n2, prm,
                   buf.z + static_cast<long long>(f) * 2 * prm.n_lm);
    buf.p_out[row + j] = x;
    buf.p_out[plane + row + j] = y;
    buf.p_out[2 * plane + row + j] = yaw;
    buf.lw_out[row + j] = lw;
  }
  block_partial_row<kBlock>(
      valid, lw, x, y, yaw, j,
      buf.parts + (static_cast<long long>(f) * gridDim.x + blockIdx.x) *
                      kPartStride);
}

template <int MODE>
void launch_stats(bool fused, dim3 grid, cudaStream_t stream,
                  const WideBuffers& buf, const WideParams& prm) {
  if (fused) {
    wide_stats_kernel<MODE, true><<<grid, kBlock, 0, stream>>>(buf, prm);
  } else {
    wide_stats_kernel<MODE, false><<<grid, kBlock, 0, stream>>>(buf, prm);
  }
}

}  // namespace

// C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.

// cum: (B, n) inclusive prefixes of the quantized weights, filter order;
// fids, valid, inv_tot, offs: (B,) per slot.  Writes t_hi: (B, n) int32 in
// slot order, at the valid slots only.
extern "C" int tpuslam_wide_boundary(const float* cum, const int* fids,
                                     const unsigned char* valid,
                                     const float* inv_tot, const float* offs,
                                     int* t_hi, int n, int b, void* stream) {
  if (n < 1 || n >= (1 << 24) || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBlock - 1) / kBlock, b);
  wide_boundary_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      cum, fids, valid, inv_tot, offs, t_hi, n);
  return static_cast<int>(cudaGetLastError());
}

// buffers: a WideBuffers, params: a WideParams, both in host memory.
// fused != 0 reads src and expanded.
extern "C" int tpuslam_wide_stats(const void* buffers, const void* params,
                                  int mode, int fused, void* stream) {
  const WideBuffers& buf = *static_cast<const WideBuffers*>(buffers);
  const WideParams& p = *static_cast<const WideParams*>(params);
  if (p.n < 1 || p.n >= (1 << 24) || p.b < 1 || p.b > 65535 ||
      p.n_lm < 0 || p.n_lm > kMaxLandmarks || mode < 0 || mode > 2 ||
      (mode == 2 && buf.normals == nullptr) ||
      (fused && (buf.src == nullptr || buf.expanded == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p.n + kBlock - 1) / kBlock, p.b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch_stats<0>(fused != 0, grid, s, buf, p); break;
    case 1: launch_stats<1>(fused != 0, grid, s, buf, p); break;
    default: launch_stats<2>(fused != 0, grid, s, buf, p); break;
  }
  return static_cast<int>(cudaGetLastError());
}
