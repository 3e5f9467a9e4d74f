// Device twins of tpuslam_torch/ops/fastmath.py: polynomial sincos,
// Box-Muller from random bits, and the Philox4x32-10 generator.
//
// Every constant is the float32 rounding of the JAX package's double
// constant (tpuslam/ops/fastmath.py), written as an exact hex literal so
// that no expression is promoted to double.  Build without
// --use_fast_math: the kernels also call the builtin sinf/cosf, which must
// stay the accurate ones.
#pragma once

#include <cstdint>

namespace tpuslam {

constexpr float kPi = 0x1.921fb6p+1f;         // 3.14159274
constexpr float kTwoPi = 0x1.921fb6p+2f;      // 6.28318548
constexpr float kHalfPi = 0x1.921fb6p+0f;     // 1.57079637
constexpr float kInvTwoPi = 0x1.45f306p-3f;   // 0.159154937
constexpr float kTwoPowMinus24 = 0x1p-24f;

// (cos, sin) of 2*pi*u for u in [0, 1): quadrant fold, then
// sin(h) = h P(h^2) and cos(h) = Q(h^2) on the quarter turn.
__device__ __forceinline__ void sincos_turns(float u, float* c, float* s) {
  const float t = u * 4.0f;
  const float q = floorf(t);
  const float h = (t - q) * kHalfPi;
  const float h2 = h * h;
  float sp = 0x1.5c007cp-19f;                  //  2.5928162e-06
  sp = sp * h2 + -0x1.9f488cp-13f;             // -1.9802255e-04
  sp = sp * h2 + 0x1.110da8p-7f;               //  8.3329267e-03
  sp = sp * h2 + -0x1.55553ep-3f;              // -1.6666650e-01
  sp = sp * h2 + 0x1p+0f;                      //  0.99999998 -> 1
  sp = h * sp;
  float cp = -0x1.18002ap-22f;                 // -2.6077093e-07
  cp = cp * h2 + 0x1.9f6f3ep-16f;              //  2.4761829e-05
  cp = cp * h2 + -0x1.6c137ap-10f;             // -1.3888400e-03
  cp = cp * h2 + 0x1.555548p-5f;               //  4.1666640e-02
  cp = cp * h2 + -0x1p-1f;                     // -0.49999999 -> -0.5
  cp = cp * h2 + 0x1p+0f;                      //  1
  if (q == 1.0f) {
    *c = -sp; *s = cp;
  } else if (q == 2.0f) {
    *c = -cp; *s = -sp;
  } else if (q == 3.0f) {
    *c = sp; *s = -cp;
  } else {
    *c = cp; *s = sp;
  }
}

// (cos, sin) of an angle in radians of any magnitude.
__device__ __forceinline__ void sincos_rad(float theta, float* c, float* s) {
  float u = theta * kInvTwoPi;
  u = u - floorf(u);
  sincos_turns(u, c, s);
}

// One Box-Muller pair from two random words: the 24 high bits of each,
// u1 shifted by half an ulp so that it is never 0.
__device__ __forceinline__ float2 normals_from_bits(uint32_t b1, uint32_t b2) {
  const float u1 = (static_cast<float>(b1 >> 8) + 0.5f) * kTwoPowMinus24;
  const float u2 = static_cast<float>(b2 >> 8) * kTwoPowMinus24;
  const float r = sqrtf(-2.0f * logf(u1));
  float c, s;
  sincos_turns(u2, &c, &s);
  return make_float2(r * c, r * s);
}

// Philox4x32-10 (Salmon et al., SC'11): ten rounds of two 32x32->64
// multiplies, the key bumped by the Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// Angle wrap of tpuslam/core/angles.py::wrap_angle in closed form.
__device__ __forceinline__ float wrap_angle(float a) {
  const float mag = fabsf(a);
  const float k = fmaxf(ceilf((mag - kPi) / kTwoPi), 0.0f);
  const float w = mag - kTwoPi * k;
  return a < 0.0f ? -w : w;
}

}  // namespace tpuslam
