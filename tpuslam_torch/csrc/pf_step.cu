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
// (3, N).  Modes 1 and 2 use the polynomial sincos.  The per-particle math
// and the partial-row reduction live in pf_math.cuh, shared with K4 and
// K5b.  The parameter struct is a __grid_constant__, so predict_loglik's
// reference to it reads the parameter space and nvcc makes no local copy.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "occupancy.cuh"
#include "pf_math.cuh"

namespace {

using tpuslam::block_partial_row;
using tpuslam::kMaxLandmarks;
using tpuslam::kPartStride;
using tpuslam::philox_normals3;
using tpuslam::predict_loglik;

constexpr int kBlock = 256;

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

template <int MODE, bool STATS>
__global__ void __launch_bounds__(kBlock)
pf_step_kernel(const float* __restrict__ p_in,
               const float* __restrict__ lw_in, const float* __restrict__ z,
               const float* __restrict__ normals, float* __restrict__ p_out,
               float* __restrict__ lw_out, float* __restrict__ parts,
               const __grid_constant__ PfParams prm) {
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
    if (MODE == tpuslam::kNoisePhilox) {
      philox_normals3(static_cast<uint32_t>(i), 0u, prm.key0, prm.key1, n0,
                      n1, n2);
    } else if (MODE == tpuslam::kNoiseNormals) {
      n0 = normals[i];
      n1 = normals[n + i];
      n2 = normals[2 * n + i];
    }
    const float acc = predict_loglik<MODE>(x, y, yaw, n0, n1, n2, prm, z);
    const float lw0 = (STATS && prm.flag > 0.0f) ? 0.0f : lw_in[i];
    lw = lw0 + acc;
    p_out[i] = x;
    p_out[n + i] = y;
    p_out[2 * n + i] = yaw;
    lw_out[i] = lw;
  }
  if (!STATS) return;
  block_partial_row<kBlock>(
      valid, lw, x, y, yaw, static_cast<int>(i),
      parts + static_cast<long long>(blockIdx.x) * kPartStride);
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

// Resident blocks per SM of kernel `which` (0: K2b, 1: K2a, Philox mode),
// *name its name; cudaErrorInvalidValue past the last.  n is unused.
extern "C" int tpuslam_occupancy_pf_step(int which, int n, int* blocks,
                                         const char** name) {
  (void)n;
  switch (which) {
    case 0:
      return tpuslam::occupancy(pf_step_kernel<1, true>, "K2b pf_step",
                                kBlock, 0, blocks, name);
    case 1:
      return tpuslam::occupancy(pf_step_kernel<1, false>, "K2a pf_step",
                                kBlock, 0, blocks, name);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
