// K1: the fused batched EKF-SLAM rollout, one launch for all steps.
//
// Replaces tpuslam/ops/ekf_pallas.py::_ekf_kernel.  Each rollout runs
// n_steps of the reference's fused sim + filter step (main_ekf,
// extended_kalman_filter.py:86-130): five normals, the observation of the
// truth from a per-step table, dead reckoning, predict, the analytic 2x2
// update, and the wrapped yaw; it sums the squared position error and,
// optionally, the posterior position NEES.
//
// What bounds it on an H100: instruction issue.  Per rollout and step it
// reads 20 bytes of the truth table (the same row for every thread, so it
// is served from the L1/read-only cache) and writes nothing; at the end it
// writes 20 floats, 80 bytes.  A step costs a few hundred instructions:
// one and a half Philox4x32-10 calls, two and a half Box-Muller transforms,
// two polynomial sincos, the 3x3 covariance algebra.  Float32 operations
// run at the rate the SM issues instructions (128 lanes a clock), so the
// time follows the instructions a step, whatever pipe they go to.  So the
// design keeps everything in registers and spends as few instructions as
// the arithmetic allows:
//   * one thread per rollout; the 17-float carry (x_dr, x_hat, the 3x3
//     covariance, the two accumulators) lives in registers for all steps,
//     and the step loop runs inside the thread;
//   * counter-based noise (Philox keyed by the seed, counter = (rollout,
//     step, draw, 0)), so no generator state is loaded or stored and the
//     stream does not depend on the launch configuration.  The key is the
//     same for every thread, so its ten round keys are folded on the host
//     and read from the parameters (a __grid_constant__ struct);
//   * one Box-Muller pair of draw 1 serves two steps: draw 1 runs at even
//     steps only, its first normal the step's yaw normal and its second
//     the next step's, so two steps take three Philox calls and five
//     transforms, none thrown away;
//   * the loop takes two steps a pass and draws each step's normals before
//     the filter math of the step before, so the generator's chain does
//     not wait on the filter's and the compiler can interleave the two
//     (at the BASELINE sweep, two warps an SM, that chain's latency sets
//     the time);
//   * the angle wrap divides only where |angle| > pi, and the gain's
//     1 / det is one IEEE reciprocal (__frcp_rn, the same value);
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

using tpuslam::kPhiloxRounds;
using tpuslam::normals_from_bits;
using tpuslam::philox4x32_10;
using tpuslam::sincos_rad;
using tpuslam::wrap_angle;

constexpr int kBlock = 64;

// Host-folded constants; the layout matches ops/ekf_cuda.py::_EkfParams.
struct EkfParams {
  long long batch;
  int n_steps;
  uint32_t rk0[kPhiloxRounds], rk1[kPhiloxRounds];  // Philox round keys
  float vdt, wdt;        // v*dt, w*dt (folded in double)
  float q0, q1, q2;      // q_std^2 (folded in double)
  float r0sq, r1sq;      // r_std^2 (folded in double)
  float qa0, qa1, qa2;   // q_act_std
  float ra0, ra1;        // r_act_std
  float x0, x1, x2;      // initial pose
  float p00, p11, p22;   // initial covariance diagonal
};

// A step's five normals: observation x, y; dead reckoning x, y, yaw.
struct Noise {
  float n0, n1, n2, n3, n4;
};

// The filter's carry.
struct Carry {
  float xd0, xd1, xd2, xh0, xh1, xh2;
  float p00, p01, p02, p10, p11, p12, p20, p21, p22;
  float acc, acc_n;
};

// Step k's n0..n3: Philox draw 0 in mode 1, the caller's normals in mode 2
// (a step past the last reads the last, unused), zeros in mode 0.
template <int MODE>
__device__ __forceinline__ void draw_xy(const EkfParams& p,
                                        const float* __restrict__ normals,
                                        long long i, int k, Noise& w) {
  if (MODE == 1) {
    const uint4 a = philox4x32_10(
        make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(k), 0u, 0u),
        p.rk0, p.rk1);
    const float2 g0 = normals_from_bits(a.x, a.y);
    const float2 g1 = normals_from_bits(a.z, a.w);
    w.n0 = g0.x; w.n1 = g0.y; w.n2 = g1.x; w.n3 = g1.y;
  } else if (MODE == 2) {
    const long long nb = p.batch;
    const float* nk = normals + static_cast<long long>(min(k, p.n_steps - 1)) *
                                    5 * nb + i;
    w.n0 = __ldg(nk);
    w.n1 = __ldg(nk + nb);
    w.n2 = __ldg(nk + 2 * nb);
    w.n3 = __ldg(nk + 3 * nb);
  } else {
    w.n0 = 0.0f; w.n1 = 0.0f; w.n2 = 0.0f; w.n3 = 0.0f;
  }
}

// The yaw normals n4 of an even step k and of step k + 1: one Box-Muller
// pair of Philox draw 1 at step k in mode 1, the caller's in mode 2.
template <int MODE>
__device__ __forceinline__ float2 draw_yaw(const EkfParams& p,
                                           const float* __restrict__ normals,
                                           long long i, int k) {
  if (MODE == 1) {
    const uint4 b = philox4x32_10(
        make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(k), 1u, 0u),
        p.rk0, p.rk1);
    return normals_from_bits(b.x, b.y);
  } else if (MODE == 2) {
    const long long nb = p.batch;
    const float* n4 = normals + 4 * nb + i;
    return make_float2(
        __ldg(n4 + static_cast<long long>(min(k, p.n_steps - 1)) * 5 * nb),
        __ldg(n4 + static_cast<long long>(min(k + 1, p.n_steps - 1)) * 5 * nb));
  }
  return make_float2(0.0f, 0.0f);
}

// One fused sim + filter step k with the normals w.
template <int MODE, bool WITH_NEES>
__device__ __forceinline__ void step(const EkfParams& p,
                                     const float* __restrict__ tbl, int k,
                                     const Noise& w, Carry& c) {
  // Truth row [xt0, xt1, xt2, cos(xt2), sin(xt2)], the same for all.
  const float* row = tbl + 5 * k;
  const float xt0 = __ldg(row);
  const float xt1 = __ldg(row + 1);
  const float c_t = __ldg(row + 3);
  const float s_t = __ldg(row + 4);

  // Observation: robot-frame noise rotated by xt2 - pi/2.  The noise
  // terms' roundings are spelled out here and below: which product an FMA
  // takes is otherwise the compiler's choice, which moves with the
  // branches around the code, and mode 2's results with it.
  const float wx = __fmul_rn(w.n0, p.ra0);
  const float wy = __fmul_rn(w.n1, p.ra1);
  const float z0 = __fadd_rn(xt0, __fmaf_rn(c_t, wy, __fmul_rn(s_t, wx)));
  const float z1 = __fadd_rn(xt1, __fmaf_rn(s_t, wy, -__fmul_rn(c_t, wx)));

  // Dead reckoning; the yaw is wrapped after the noise is added.
  float c_d, s_d;
  if (MODE != 0) {
    sincos_rad(c.xd2, &c_d, &s_d);
  } else {
    c_d = cosf(c.xd2);
    s_d = sinf(c.xd2);
  }
  c.xd0 = __fmaf_rn(w.n2, p.qa0, __fmaf_rn(p.vdt, c_d, c.xd0));
  c.xd1 = __fmaf_rn(w.n3, p.qa1, __fmaf_rn(p.vdt, s_d, c.xd1));
  c.xd2 = wrap_angle(__fmaf_rn(w.n4, p.qa2, __fadd_rn(c.xd2, p.wdt)));

  // Predict: P- = jF P jF^T + Q with jF = I + a e0 e2^T + b e1 e2^T.
  float c_h, s_h;
  if (MODE != 0) {
    sincos_rad(c.xh2, &c_h, &s_h);
  } else {
    c_h = cosf(c.xh2);
    s_h = sinf(c.xh2);
  }
  const float xp0 = c.xh0 + p.vdt * c_h;
  const float xp1 = c.xh1 + p.vdt * s_h;
  const float xp2 = wrap_angle(c.xh2 + p.wdt);
  const float a = -p.vdt * s_h;
  const float b = p.vdt * c_h;
  const float m00 = c.p00 + a * c.p20;
  const float m01 = c.p01 + a * c.p21;
  const float m02 = c.p02 + a * c.p22;
  const float m10 = c.p10 + b * c.p20;
  const float m11 = c.p11 + b * c.p21;
  const float m12 = c.p12 + b * c.p22;
  const float p00 = m00 + a * m02 + p.q0;
  const float p01 = m01 + b * m02;
  const float p02 = m02;
  const float p10 = m10 + a * m12;
  const float p11 = m11 + b * m12 + p.q1;
  const float p12 = m12;
  const float p20 = c.p20 + a * c.p22;
  const float p21 = c.p21 + b * c.p22;
  const float p22 = c.p22 + p.q2;

  // Update with the analytic inverse of S = P-[0:2, 0:2] + R.
  const float s00 = p00 + p.r0sq;
  const float s01 = p01;
  const float s10 = p10;
  const float s11 = p11 + p.r1sq;
  const float det = s00 * s11 - s01 * s10;
  const float inv = __frcp_rn(det);
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
  c.xh0 = xp0 + g00 * e0 + g01 * e1;
  c.xh1 = xp1 + g10 * e0 + g11 * e1;
  c.xh2 = wrap_angle(xp2 + g20 * e0 + g21 * e1);
  c.p00 = p00 - (g00 * p00 + g01 * p10);
  c.p01 = p01 - (g00 * p01 + g01 * p11);
  c.p02 = p02 - (g00 * p02 + g01 * p12);
  c.p10 = p10 - (g10 * p00 + g11 * p10);
  c.p11 = p11 - (g10 * p01 + g11 * p11);
  c.p12 = p12 - (g10 * p02 + g11 * p12);
  c.p20 = p20 - (g20 * p00 + g21 * p10);
  c.p21 = p21 - (g20 * p01 + g21 * p11);
  c.p22 = p22 - (g20 * p02 + g21 * p12);

  // Posterior position error and NEES against its 2x2 block.
  const float d0 = c.xh0 - xt0;
  const float d1 = c.xh1 - xt1;
  c.acc = c.acc + d0 * d0 + d1 * d1;
  if (WITH_NEES) {
    const float det_n = c.p00 * c.p11 - c.p01 * c.p10;
    c.acc_n = c.acc_n + (c.p11 * d0 * d0 - (c.p01 + c.p10) * d0 * d1 +
                         c.p00 * d1 * d1) / det_n;
  }
}

template <int MODE, bool WITH_NEES>
__global__ void __launch_bounds__(kBlock)
ekf_rollout_kernel(const float* __restrict__ tbl,
                   const float* __restrict__ normals,
                   float* __restrict__ state, float* __restrict__ cov,
                   float* __restrict__ err, const __grid_constant__ EkfParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= p.batch) return;
  const long long nb = p.batch;

  Carry c{p.x0, p.x1, p.x2, p.x0, p.x1, p.x2,
          p.p00, 0.0f, 0.0f, 0.0f, p.p11, 0.0f, 0.0f, 0.0f, p.p22,
          0.0f, 0.0f};
  // Step k's normals are drawn before step k - 1's filter math.
  Noise cur, nxt;
  draw_xy<MODE>(p, normals, i, 0, cur);
  float2 yaw = draw_yaw<MODE>(p, normals, i, 0);
  cur.n4 = yaw.x;
  int k = 0;
#pragma unroll 1
  for (; k + 1 < p.n_steps; k += 2) {
    draw_xy<MODE>(p, normals, i, k + 1, nxt);
    nxt.n4 = yaw.y;
    step<MODE, WITH_NEES>(p, tbl, k, cur, c);
    draw_xy<MODE>(p, normals, i, k + 2, cur);
    yaw = draw_yaw<MODE>(p, normals, i, k + 2);
    cur.n4 = yaw.x;
    step<MODE, WITH_NEES>(p, tbl, k + 1, nxt, c);
  }
  if (k < p.n_steps) step<MODE, WITH_NEES>(p, tbl, k, cur, c);

  const float* last = tbl + 5 * (p.n_steps - 1);
  state[i] = __ldg(last);
  state[nb + i] = __ldg(last + 1);
  state[2 * nb + i] = __ldg(last + 2);
  state[3 * nb + i] = c.xd0;
  state[4 * nb + i] = c.xd1;
  state[5 * nb + i] = c.xd2;
  state[6 * nb + i] = c.xh0;
  state[7 * nb + i] = c.xh1;
  state[8 * nb + i] = c.xh2;
  cov[i] = c.p00;
  cov[nb + i] = c.p01;
  cov[2 * nb + i] = c.p02;
  cov[3 * nb + i] = c.p10;
  cov[4 * nb + i] = c.p11;
  cov[5 * nb + i] = c.p12;
  cov[6 * nb + i] = c.p20;
  cov[7 * nb + i] = c.p21;
  cov[8 * nb + i] = c.p22;
  err[i] = c.acc;
  err[nb + i] = c.acc_n;
}

// ---------------------------------------------------------------------------
// K1's small-batch form: four lanes of a warp carry one rollout.
//
// Replaces no TPU kernel of its own: it is K1 (the same rollouts and the
// same output words) for batches too small to fill the card at a thread a
// rollout.  At 8192 rollouts the form above runs 256 warps, under two an
// SM, so one warp's instruction stream a step and its latencies (the
// wraps' branches, the IEEE reciprocal and divides, MUFU, the dependent
// chains of the polynomials and the 3x3 algebra) set the time, with no
// other warp to cover them.  Here lanes 4i..4i+3 carry rollout i: the same
// batch runs four times the warps, and a lane issues about three fifths of
// the one-thread stream a step (326 SASS instructions against 521 in the
// Philox NEES loop).  What bounds it is still a warp's latency a step,
// with two warps on a scheduler at 8192 rollouts: the noise's chains
// (a third of the time), the wraps', reciprocal's and divide's branches,
// which cut a step into short basic blocks.  Above about 100 rollouts an
// SM the replicated work (every lane runs the sincos, S, 1 / det, the
// wraps and the noise's transforms) makes it issue-bound and slower than
// the one-thread form, so the launch picks the form by the batch.  The
// lanes split a step so (g is a lane's place in its group of four):
//   * lane g < 3 owns row g of P, of P- and of the gain, and x_hat[g];
//     lane 3 owns the dead reckoning; lane 0 the two accumulators;
//   * the two sincos are one instruction stream: lanes 0-2 take it of
//     x_hat[2], which each of them updates (row 2 of P- and of the gain
//     are formed in every lane), lane 3 of x_dr[2]; so are the wraps
//     (lanes 0-2 the predicted yaw, lane 3 its new yaw);
//   * a two-step pass draws lane 0 Philox (k+1, 0), lane 1 (k+2, 0) and
//     lanes 2-3 (k+2, 1), on the counters and folded round keys of the
//     form above, after step k's determinant; its five Box-Muller
//     transforms run in two rounds (lanes 0-2 their first pair and lane 3
//     lane 0's second, then lane 3 lane 1's second), so lane 3 holds the
//     dead reckoning's normals, and the observation's are broadcast;
//   * every lane forms S, det and 1 / det from rows 0-1 of P- (four
//     shuffles); P = P- - G P-[0:2], the squared error and NEES's terms
//     are finished at the start of the next step, where they overlap its
//     sincos instead of waiting behind the wraps' branches;
//   * shuffles of width 4 join the lanes, so a step needs no barrier.
// Each operation is spelled out with __fmaf_rn/__fmul_rn/__fadd_rn/
// __fsub_rn in the operands, order and fused multiply-adds that the form
// above has in its compiled code (read from its SASS): there nvcc leaves
// the predicted position x_hat + vdt * (cos, sin) unfused in the loop's
// steps and fuses it in the step after the loop, so that step is a
// template case here too.
// ---------------------------------------------------------------------------

constexpr int kLanes = 4;         // lanes a rollout
constexpr int kLanesBlock = 128;  // threads a block: 32 rollouts
constexpr unsigned kWarp = 0xffffffffu;

__device__ __forceinline__ float lane_of(float v, int src) {
  return __shfl_sync(kWarp, v, src, kLanes);
}
__device__ __forceinline__ uint32_t lane_of(uint32_t v, int src) {
  return __shfl_sync(kWarp, v, src, kLanes);
}

// A step's normals as the lanes hold them: the observation's n0, n1 in
// lanes 0-1, which form it, the dead reckoning's n2, n3, n4 in lane 3.
struct LaneNoise {
  float w0, w1, d2, d3, d4;
};

// A lane's carry.  Lane g < 3: row g of P- and of the gain, rows 0-1 of
// P- and its innovation terms, left for the next step to finish (see
// finish_lanes), and x_hat[g]; every lane x_hat[2], lane 3 the dead
// reckoning in its place; lane 0 the accumulators.
struct LaneCarry {
  float c0, c1, c2;                  // row g of P-
  float g0, g1;                      // row g of the gain
  float p00, p01, p02, p10, p11, p12;  // rows 0-1 of P-
  float d;                           // x_hat[g] - x_true[g] (lanes 0-1)
  float xr, yaw, xd0, xd1, acc, acc_n;
};

// Mode 2: step k's normals from the caller's rows (k clamped into range):
// n0, n1 in lanes 0-2, n2, n3, n4 in lane 3.
__device__ __forceinline__ void read_step(const EkfParams& p,
                                          const float* __restrict__ normals,
                                          long long i, int g, int k,
                                          LaneNoise& s) {
  const long long nb = p.batch;
  const float* nk = normals +
                    static_cast<long long>(max(0, min(k, p.n_steps - 1))) *
                        5 * nb + i;
  const long long j0 = g == 3 ? 2 : 0;
  s.w0 = s.d2 = __ldg(nk + j0 * nb);
  s.w1 = s.d3 = __ldg(nk + (j0 + 1) * nb);
  s.d4 = __ldg(nk + 4 * nb);
}

// The normals of steps k+1 (s1) and k+2 (s2) of the pass at k; `yaw`
// brings in the second normal of step k's draw 1 and takes out step
// k+2's.
template <int MODE>
__device__ __forceinline__ void draw_pass(const EkfParams& p,
                                          const float* __restrict__ normals,
                                          long long i, int g, int k,
                                          LaneNoise& s1, LaneNoise& s2,
                                          float& yaw) {
  if (MODE == 1) {
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(i),
                   static_cast<uint32_t>(k + (g == 0 ? 1 : 2)),
                   g >= 2 ? 1u : 0u, 0u),
        p.rk0, p.rk1);
    const uint32_t z0 = lane_of(bits.z, 0), w0 = lane_of(bits.w, 0);
    const uint32_t z1 = lane_of(bits.z, 1), w1 = lane_of(bits.w, 1);
    const float2 t1 = normals_from_bits(g == 3 ? z0 : bits.x,
                                        g == 3 ? w0 : bits.y);
    const float2 t2 = normals_from_bits(z1, w1);
    s1 = LaneNoise{lane_of(t1.x, 0), lane_of(t1.y, 0), t1.x, t1.y, yaw};
    s2 = LaneNoise{lane_of(t1.x, 1), lane_of(t1.y, 1), t2.x, t2.y,
                   lane_of(t1.x, 2)};
    yaw = lane_of(t1.y, 2);
  } else if (MODE == 2) {
    read_step(p, normals, i, g, k + 1, s1);
    read_step(p, normals, i, g, k + 2, s2);
  } else {
    s1 = LaneNoise{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    s2 = s1;
  }
}

// The end of step(): P = P- - G P-[0:2] (row g), the squared error and,
// with NEES, its numerator and determinant (lane 0).  A step runs it for
// the step before, where it overlaps the step's sincos; the kernel runs it
// once after the last step.  From the carry's first state it leaves P,
// acc and the NEES terms as they are (a zero gain and error).
template <bool WITH_NEES>
__device__ __forceinline__ void finish_lanes(int g, LaneCarry& c,
                                             float& r0, float& r1, float& r2,
                                             float& num, float& det_n) {
  r0 = __fsub_rn(c.c0, __fmaf_rn(c.p00, c.g0, __fmul_rn(c.p10, c.g1)));
  r1 = __fsub_rn(c.c1, __fmaf_rn(c.p01, c.g0, __fmul_rn(c.p11, c.g1)));
  r2 = __fsub_rn(c.c2, __fmaf_rn(c.p02, c.g0, __fmul_rn(c.p12, c.g1)));
  const float d1 = lane_of(c.d, 1);
  c.acc = __fmaf_rn(d1, d1, __fmaf_rn(c.d, c.d, c.acc));
  if (WITH_NEES) {
    const float n10 = lane_of(r0, 1), n11 = lane_of(r1, 1);
    det_n = __fmaf_rn(r0, n11, -__fmul_rn(r1, n10));
    num = __fmaf_rn(
        d1, __fmul_rn(r0, d1),
        __fmaf_rn(c.d, __fmul_rn(n11, c.d),
                  -__fmul_rn(d1, __fmul_rn(__fadd_rn(r1, n10), c.d))));
    // Other lanes divide 1 by 1, off the divide's slow path.
    if (g != 0) num = det_n = 1.0f;
  }
}

// step() of lane g with the normals s, after finishing the step before;
// LAST is the step after the loop.  at_det runs other work (the pass's
// noise) after the determinant, where it shares a basic block with the
// filter's dependent chain instead of waiting in one of its own.
template <int MODE, bool WITH_NEES, bool LAST, typename AtDet>
__device__ __forceinline__ void step_lanes(const EkfParams& p,
                                           const float* __restrict__ tbl,
                                           int k, int g, const LaneNoise& s,
                                           LaneCarry& c, AtDet&& at_det) {
  // Lane g < 2 reads x_true[g] (lanes 2-3 x_true[1], unused).
  const float* row = tbl + 5 * k;
  const float xt = __ldg(row + (g == 0 ? 0 : 1));
  const float c_t = __ldg(row + 3);
  const float s_t = __ldg(row + 4);

  // Observation: lane 0 z0, lane 1 z1.
  const float wx = __fmul_rn(s.w0, p.ra0);
  const float wy = __fmul_rn(s.w1, p.ra1);
  const float z = g == 0
      ? __fadd_rn(xt, __fmaf_rn(c_t, wy, __fmul_rn(s_t, wx)))
      : __fadd_rn(xt, __fmaf_rn(s_t, wy, -__fmul_rn(c_t, wx)));

  float cs, sn;
  if (MODE != 0) {
    sincos_rad(c.yaw, &cs, &sn);
  } else {
    cs = cosf(c.yaw);
    sn = sinf(c.yaw);
  }
  c.xd0 = __fmaf_rn(s.d2, p.qa0, __fmaf_rn(p.vdt, cs, c.xd0));
  c.xd1 = __fmaf_rn(s.d3, p.qa1, __fmaf_rn(p.vdt, sn, c.xd1));

  float r0, r1, r2, num = 0.0f, det_n = 1.0f;
  finish_lanes<WITH_NEES>(g, c, r0, r1, r2, num, det_n);

  // Predict row g: M = P + coef P[2] (row 2 as it is), P- = M jF^T + Q;
  // every lane also forms row 2 of P-, for the yaw's update.
  const float t = __fmul_rn(p.vdt, sn);
  const float a = -t;
  const float b = __fmul_rn(p.vdt, cs);
  float xp = 0.0f;
  if (g < 2) {
    xp = LAST ? __fmaf_rn(p.vdt, g == 0 ? cs : sn, c.xr)
              : __fadd_rn(c.xr, g == 0 ? b : t);
  }
  const float q20 = lane_of(r0, 2), q21 = lane_of(r1, 2),
              q22 = lane_of(r2, 2);
  float m0 = r0, m1 = r1, m2 = r2;
  if (g < 2) {
    const float coef = g == 0 ? a : b;
    m0 = __fmaf_rn(coef, q20, r0);
    m1 = __fmaf_rn(coef, q21, r1);
    m2 = __fmaf_rn(coef, q22, r2);
  }
  // Q's diagonal enters column g; -0.0f elsewhere, since x + -0 == x.
  c.c0 = __fadd_rn(__fmaf_rn(a, m2, m0), g == 0 ? p.q0 : -0.0f);
  c.c1 = __fadd_rn(__fmaf_rn(b, m2, m1), g == 1 ? p.q1 : -0.0f);
  c.c2 = __fadd_rn(m2, g == 2 ? p.q2 : -0.0f);
  const float p20 = __fmaf_rn(a, q22, q20);
  const float p21 = __fmaf_rn(b, q22, q21);

  // S = P-[0:2, 0:2] + R, its determinant and inverse, in every lane.
  c.p00 = lane_of(c.c0, 0); c.p01 = lane_of(c.c1, 0);
  c.p10 = lane_of(c.c0, 1); c.p11 = lane_of(c.c1, 1);
  c.p02 = lane_of(c.c2, 0); c.p12 = lane_of(c.c2, 1);
  const float s00 = __fadd_rn(c.p00, p.r0sq);
  const float s11 = __fadd_rn(c.p11, p.r1sq);
  const float det = __fmaf_rn(s00, s11, -__fmul_rn(c.p01, c.p10));
  at_det();
  if (WITH_NEES) c.acc_n = __fadd_rn(c.acc_n, __fdiv_rn(num, det_n));
  const float inv = __frcp_rn(det);
  const float i00 = __fmul_rn(s11, inv);
  const float i01 = __fmul_rn(-c.p01, inv);
  const float i10 = __fmul_rn(-c.p10, inv);
  const float i11 = __fmul_rn(s00, inv);
  // Gain rows g and 2; the innovation (lane 0 e0, lane 1 e1).
  c.g0 = __fmaf_rn(c.c0, i00, __fmul_rn(c.c1, i10));
  c.g1 = __fmaf_rn(c.c1, i11, __fmul_rn(c.c0, i01));
  const float g20 = __fmaf_rn(p20, i00, __fmul_rn(p21, i10));
  const float g21 = __fmaf_rn(p21, i11, __fmul_rn(p20, i01));
  const float e = __fsub_rn(z, xp);
  const float e0 = lane_of(e, 0), e1 = lane_of(e, 1);
  const float xn = __fmaf_rn(c.g1, e1, __fmaf_rn(c.g0, e0, xp));
  c.d = __fsub_rn(xn, xt);
  // The yaws: lanes 0-2 wrap x_hat[2] + w dt, update and wrap it again;
  // lane 3 wraps its new dead-reckoning yaw (and then 0, which never
  // branches).
  const float u = __fadd_rn(c.yaw, p.wdt);
  const float wt = wrap_angle(g == 3 ? __fmaf_rn(s.d4, p.qa2, u) : u);
  const float wn = wrap_angle(
      g == 3 ? 0.0f : __fmaf_rn(g21, e1, __fmaf_rn(g20, e0, wt)));
  c.yaw = g == 3 ? wt : wn;
  c.xr = g == 2 ? wn : xn;
}

template <int MODE, bool WITH_NEES>
__global__ void __launch_bounds__(kLanesBlock)
ekf_rollout_kernel_lanes(const float* __restrict__ tbl,
                         const float* __restrict__ normals,
                         float* __restrict__ state, float* __restrict__ cov,
                         float* __restrict__ err,
                         const __grid_constant__ EkfParams p) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kLanesBlock + threadIdx.x;
  const int g = static_cast<int>(threadIdx.x) & (kLanes - 1);
  // A group past the batch reruns the last rollout and stores nothing,
  // so every lane of a warp reaches every shuffle.
  const bool live = t / kLanes < p.batch;
  const long long i = live ? t / kLanes : p.batch - 1;
  const long long nb = p.batch;

  // P- and the pending terms start as P0 with a zero gain and error, so
  // the first step's finish_lanes leaves them as they are.
  const float r0 = g == 0 ? p.p00 : 0.0f, r1 = g == 1 ? p.p11 : 0.0f,
              r2 = g == 2 ? p.p22 : 0.0f;
  LaneCarry c{r0, r1, r2, 0.0f, 0.0f,
              p.p00, 0.0f, 0.0f, 0.0f, p.p11, 0.0f, 0.0f,
              g == 0 ? p.x0 : (g == 1 ? p.x1 : p.x2), p.x2,
              p.x0, p.x1, 0.0f, 0.0f};
  LaneNoise cur, nxt, after;
  float yaw_pair = 0.0f;
  // The pass before step 0 draws step 0's normals (its step -1 is unused).
  draw_pass<MODE>(p, normals, i, g, -2, nxt, cur, yaw_pair);
  const auto none = [] {};
  int k = 0;
#pragma unroll 1
  for (; k + 1 < p.n_steps; k += 2) {
    step_lanes<MODE, WITH_NEES, false>(p, tbl, k, g, cur, c, [&] {
      draw_pass<MODE>(p, normals, i, g, k, nxt, after, yaw_pair);
    });
    step_lanes<MODE, WITH_NEES, false>(p, tbl, k + 1, g, nxt, c, none);
    cur = after;
  }
  if (k < p.n_steps) {
    step_lanes<MODE, WITH_NEES, true>(p, tbl, k, g, cur, c, none);
  }
  float r0n, r1n, r2n, num = 0.0f, det_n = 1.0f;
  finish_lanes<WITH_NEES>(g, c, r0n, r1n, r2n, num, det_n);
  if (WITH_NEES) c.acc_n = __fadd_rn(c.acc_n, __fdiv_rn(num, det_n));

  if (!live) return;
  if (g < 3) {
    state[(6 + g) * nb + i] = c.xr;
    cov[3 * g * nb + i] = r0n;
    cov[(3 * g + 1) * nb + i] = r1n;
    cov[(3 * g + 2) * nb + i] = r2n;
  } else {
    const float* last = tbl + 5 * (p.n_steps - 1);
    state[i] = __ldg(last);
    state[nb + i] = __ldg(last + 1);
    state[2 * nb + i] = __ldg(last + 2);
    state[3 * nb + i] = c.xd0;
    state[4 * nb + i] = c.xd1;
    state[5 * nb + i] = c.yaw;
  }
  if (g == 0) {
    err[i] = c.acc;
    err[nb + i] = c.acc_n;
  }
}

template <int MODE, bool WITH_NEES>
void launch(int lanes, cudaStream_t stream, const float* tbl,
            const float* normals, float* state, float* cov, float* err,
            const EkfParams& p) {
  if (lanes == kLanes) {
    const dim3 grid(static_cast<unsigned>(
        (p.batch * kLanes + kLanesBlock - 1) / kLanesBlock));
    ekf_rollout_kernel_lanes<MODE, WITH_NEES><<<grid, kLanesBlock, 0,
                                               stream>>>(
        tbl, normals, state, cov, err, p);
  } else {
    const dim3 grid(static_cast<unsigned>((p.batch + kBlock - 1) / kBlock));
    ekf_rollout_kernel<MODE, WITH_NEES><<<grid, kBlock, 0, stream>>>(
        tbl, normals, state, cov, err, p);
  }
}

template <int MODE>
void launch(bool with_nees, int lanes, cudaStream_t stream, const float* tbl,
            const float* normals, float* state, float* cov, float* err,
            const EkfParams& p) {
  if (with_nees) {
    launch<MODE, true>(lanes, stream, tbl, normals, state, cov, err, p);
  } else {
    launch<MODE, false>(lanes, stream, tbl, normals, state, cov, err, p);
  }
}

}  // namespace

// C entry point for ctypes.  `params` is a filled template (every field
// but `batch` and the round keys), which stays read-only: the entry copies
// it, sets `batch` and folds the Philox key (seed_lo, seed_hi) into the
// round keys, then launches on `stream` the form with `lanes` lanes a
// rollout (1, or 4 for the small-batch form; ops/ekf_cuda.py::k1_lanes
// picks it) and returns cudaGetLastError() (0 when the launch was
// accepted); never synchronises.
extern "C" int tpuslam_ekf_rollout(const float* tbl, const float* normals,
                                   float* state, float* cov, float* err,
                                   const void* params, long long batch,
                                   uint32_t seed_lo, uint32_t seed_hi,
                                   int mode, int with_nees, int lanes,
                                   void* stream) {
  EkfParams p = *static_cast<const EkfParams*>(params);
  p.batch = batch;
  for (int r = 0; r < kPhiloxRounds; ++r) {
    p.rk0[r] = seed_lo + static_cast<uint32_t>(r) * tpuslam::kPhiloxW0;
    p.rk1[r] = seed_hi + static_cast<uint32_t>(r) * tpuslam::kPhiloxW1;
  }
  if (p.batch < 1 || p.n_steps < 1 || mode < 0 || mode > 2 ||
      (lanes != 1 && lanes != kLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool nees = with_nees != 0;
  switch (mode) {
    case 0: launch<0>(nees, lanes, s, tbl, normals, state, cov, err, p); break;
    case 1: launch<1>(nees, lanes, s, tbl, normals, state, cov, err, p); break;
    default: launch<2>(nees, lanes, s, tbl, normals, state, cov, err, p); break;
  }
  return static_cast<int>(cudaGetLastError());
}
