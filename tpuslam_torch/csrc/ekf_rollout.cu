// K1: the fused batched EKF-SLAM rollout, one launch for all steps.
//
// Replaces tpuslam/ops/ekf_pallas.py::_ekf_kernel.  Each rollout runs
// n_steps of the reference's fused sim + filter step (main_ekf,
// extended_kalman_filter.py:86-130): five normals, the observation of the
// truth from a per-step table, dead reckoning, predict, the analytic 2x2
// update, and the wrapped yaw; it sums the squared position error and,
// optionally, the posterior position NEES.
//
// What bounds it on an H100: arithmetic.  Per rollout and step it reads
// 20 bytes of the truth table (the same row for every thread, so it is
// served from the L1/read-only cache) and writes nothing; at the end it
// writes 20 floats, 80 bytes.  A step costs a few hundred instructions:
// two Philox4x32-10 calls, three Box-Muller transforms, two polynomial
// sincos, two divides.  So the design keeps everything in registers:
//   * one thread per rollout; the 17-float carry (x_dr, x_hat, the 3x3
//     covariance, the two accumulators) lives in registers for all steps,
//     and the step loop runs inside the thread;
//   * counter-based noise (Philox keyed by the seed, counter = (rollout,
//     step, draw, 0)), so no generator state is loaded or stored and the
//     stream does not depend on the launch configuration;
//   * the NEES divide is a template parameter and is compiled out when the
//     caller does not read it;
//   * outputs are stored structure-of-arrays, (9, B), (9, B), (2, B), so
//     neighbouring threads write neighbouring addresses.
// No sub-row packing, no tile grid and no state input buffers: those were
// the TPU's layout.  Every lane starts from cfg.x0 and diag(p0_std^2).
//
// Modes: 0 = noise off (builtin sinf/cosf, for exact parity with the plain
// path), 1 = Philox noise, 2 = caller-supplied normals of shape
// (n_steps, 5, B).  Modes 1 and 2 use the polynomial sincos.

#include <cuda_runtime.h>

#include <cstdint>

#include "fastmath.cuh"

namespace {

using tpuslam::normals_from_bits;
using tpuslam::philox4x32_10;
using tpuslam::sincos_rad;
using tpuslam::wrap_angle;

constexpr int kBlock = 64;

// Host-folded constants; the layout matches ops/ekf_cuda.py::_EkfParams.
struct EkfParams {
  long long batch;
  int n_steps;
  uint32_t key0, key1;
  float vdt, wdt;        // v*dt, w*dt (folded in double)
  float q0, q1, q2;      // q_std^2 (folded in double)
  float r0sq, r1sq;      // r_std^2 (folded in double)
  float qa0, qa1, qa2;   // q_act_std
  float ra0, ra1;        // r_act_std
  float x0, x1, x2;      // initial pose
  float p00, p11, p22;   // initial covariance diagonal
};

template <int MODE, bool WITH_NEES>
__global__ void __launch_bounds__(kBlock)
ekf_rollout_kernel(const float* __restrict__ tbl,
                   const float* __restrict__ normals,
                   float* __restrict__ state, float* __restrict__ cov,
                   float* __restrict__ err, const EkfParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= p.batch) return;
  const long long nb = p.batch;
  const uint2 key = make_uint2(p.key0, p.key1);

  float xd0 = p.x0, xd1 = p.x1, xd2 = p.x2;
  float xh0 = p.x0, xh1 = p.x1, xh2 = p.x2;
  float p00 = p.p00, p01 = 0.0f, p02 = 0.0f;
  float p10 = 0.0f, p11 = p.p11, p12 = 0.0f;
  float p20 = 0.0f, p21 = 0.0f, p22 = p.p22;
  float acc = 0.0f, acc_n = 0.0f;

  for (int k = 0; k < p.n_steps; ++k) {
    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, n3 = 0.0f, n4 = 0.0f;
    if (MODE == 1) {
      const uint4 a = philox4x32_10(
          make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(k), 0u, 0u), key);
      const uint4 b = philox4x32_10(
          make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(k), 1u, 0u), key);
      const float2 g0 = normals_from_bits(a.x, a.y);
      const float2 g1 = normals_from_bits(a.z, a.w);
      const float2 g2 = normals_from_bits(b.x, b.y);
      n0 = g0.x; n1 = g0.y; n2 = g1.x; n3 = g1.y; n4 = g2.x;
    } else if (MODE == 2) {
      const float* nk = normals + static_cast<long long>(k) * 5 * nb + i;
      n0 = __ldg(nk);
      n1 = __ldg(nk + nb);
      n2 = __ldg(nk + 2 * nb);
      n3 = __ldg(nk + 3 * nb);
      n4 = __ldg(nk + 4 * nb);
    }

    // Truth row [xt0, xt1, xt2, cos(xt2), sin(xt2)], the same for all.
    const float* row = tbl + 5 * k;
    const float xt0 = __ldg(row);
    const float xt1 = __ldg(row + 1);
    const float c_t = __ldg(row + 3);
    const float s_t = __ldg(row + 4);

    // Observation: robot-frame noise rotated by xt2 - pi/2.
    const float wx = n0 * p.ra0;
    const float wy = n1 * p.ra1;
    const float z0 = s_t * wx + c_t * wy + xt0;
    const float z1 = -c_t * wx + s_t * wy + xt1;

    // Dead reckoning; the yaw is wrapped after the noise is added.
    float c_d, s_d;
    if (MODE != 0) {
      sincos_rad(xd2, &c_d, &s_d);
    } else {
      c_d = cosf(xd2);
      s_d = sinf(xd2);
    }
    xd0 = xd0 + p.vdt * c_d + n2 * p.qa0;
    xd1 = xd1 + p.vdt * s_d + n3 * p.qa1;
    xd2 = wrap_angle(xd2 + p.wdt + n4 * p.qa2);

    // Predict: P- = jF P jF^T + Q with jF = I + a e0 e2^T + b e1 e2^T.
    float c_h, s_h;
    if (MODE != 0) {
      sincos_rad(xh2, &c_h, &s_h);
    } else {
      c_h = cosf(xh2);
      s_h = sinf(xh2);
    }
    const float xp0 = xh0 + p.vdt * c_h;
    const float xp1 = xh1 + p.vdt * s_h;
    const float xp2 = wrap_angle(xh2 + p.wdt);
    const float a = -p.vdt * s_h;
    const float b = p.vdt * c_h;
    const float m00 = p00 + a * p20;
    const float m01 = p01 + a * p21;
    const float m02 = p02 + a * p22;
    const float m10 = p10 + b * p20;
    const float m11 = p11 + b * p21;
    const float m12 = p12 + b * p22;
    p00 = m00 + a * m02 + p.q0;
    p01 = m01 + b * m02;
    p02 = m02;
    p10 = m10 + a * m12;
    p11 = m11 + b * m12 + p.q1;
    p12 = m12;
    const float p20n = p20 + a * p22;
    const float p21n = p21 + b * p22;
    p20 = p20n;
    p21 = p21n;
    p22 = p22 + p.q2;

    // Update with the analytic inverse of S = P-[0:2, 0:2] + R.
    const float s00 = p00 + p.r0sq;
    const float s01 = p01;
    const float s10 = p10;
    const float s11 = p11 + p.r1sq;
    const float det = s00 * s11 - s01 * s10;
    const float inv = 1.0f / det;
    const float i00 = s11 * inv;
    const float i01 = -s01 * inv;
    const float i10 = -s10 * inv;
    const float i11 = s00 * inv;
    const float g00 = p00 * i00 + p01 * i10;
    const float g01 = p00 * i01 + p01 * i11;
    const float g10 = p10 * i00 + p11 * i10;
    const float g11 = p10 * i01 + p11 * i11;
    const float g20 = p20 * i00 + p21 * i10;
    const float g21 = p20 * i01 + p21 * i11;
    const float e0 = z0 - xp0;
    const float e1 = z1 - xp1;
    xh0 = xp0 + g00 * e0 + g01 * e1;
    xh1 = xp1 + g10 * e0 + g11 * e1;
    xh2 = wrap_angle(xp2 + g20 * e0 + g21 * e1);
    const float n00 = p00 - (g00 * p00 + g01 * p10);
    const float n01 = p01 - (g00 * p01 + g01 * p11);
    const float n02 = p02 - (g00 * p02 + g01 * p12);
    const float n10 = p10 - (g10 * p00 + g11 * p10);
    const float n11 = p11 - (g10 * p01 + g11 * p11);
    const float n12 = p12 - (g10 * p02 + g11 * p12);
    const float n20 = p20 - (g20 * p00 + g21 * p10);
    const float n21 = p21 - (g20 * p01 + g21 * p11);
    const float n22 = p22 - (g20 * p02 + g21 * p12);
    p00 = n00; p01 = n01; p02 = n02;
    p10 = n10; p11 = n11; p12 = n12;
    p20 = n20; p21 = n21; p22 = n22;

    // Posterior position error and NEES against its 2x2 block.
    const float d0 = xh0 - xt0;
    const float d1 = xh1 - xt1;
    acc = acc + d0 * d0 + d1 * d1;
    if (WITH_NEES) {
      const float det_n = p00 * p11 - p01 * p10;
      acc_n = acc_n + (p11 * d0 * d0 - (p01 + p10) * d0 * d1 + p00 * d1 * d1) / det_n;
    }
  }

  const float* last = tbl + 5 * (p.n_steps - 1);
  state[i] = __ldg(last);
  state[nb + i] = __ldg(last + 1);
  state[2 * nb + i] = __ldg(last + 2);
  state[3 * nb + i] = xd0;
  state[4 * nb + i] = xd1;
  state[5 * nb + i] = xd2;
  state[6 * nb + i] = xh0;
  state[7 * nb + i] = xh1;
  state[8 * nb + i] = xh2;
  cov[i] = p00;
  cov[nb + i] = p01;
  cov[2 * nb + i] = p02;
  cov[3 * nb + i] = p10;
  cov[4 * nb + i] = p11;
  cov[5 * nb + i] = p12;
  cov[6 * nb + i] = p20;
  cov[7 * nb + i] = p21;
  cov[8 * nb + i] = p22;
  err[i] = acc;
  err[nb + i] = acc_n;
}

template <int MODE>
void launch(bool with_nees, dim3 grid, cudaStream_t stream, const float* tbl,
            const float* normals, float* state, float* cov, float* err,
            const EkfParams& p) {
  if (with_nees) {
    ekf_rollout_kernel<MODE, true><<<grid, kBlock, 0, stream>>>(
        tbl, normals, state, cov, err, p);
  } else {
    ekf_rollout_kernel<MODE, false><<<grid, kBlock, 0, stream>>>(
        tbl, normals, state, cov, err, p);
  }
}

}  // namespace

// C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); never synchronises.
extern "C" int tpuslam_ekf_rollout(const float* tbl, const float* normals,
                                   float* state, float* cov, float* err,
                                   const void* params, int mode, int with_nees,
                                   void* stream) {
  const EkfParams& p = *static_cast<const EkfParams*>(params);
  if (p.batch < 1 || p.n_steps < 1 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((p.batch + kBlock - 1) / kBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch<0>(with_nees != 0, grid, s, tbl, normals, state, cov, err, p); break;
    case 1: launch<1>(with_nees != 0, grid, s, tbl, normals, state, cov, err, p); break;
    default: launch<2>(with_nees != 0, grid, s, tbl, normals, state, cov, err, p); break;
  }
  return static_cast<int>(cudaGetLastError());
}
