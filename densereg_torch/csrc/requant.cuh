// The requantisation epilogue that the int8 convolutions share: K3
// (int8_gemm.cu) and the depthwise convolution (int8_dwconv.cu). Semantics
// oracle: densereg_torch.ops.int8_layout.requant_reference.
//
//   y = relu?(float(acc) * scale + bias)         (float32)
//   q = clamp(rint(y / s_y), -127, 127)          (int8)
//
// Numerics: build with --fmad=false, without -ftz and without
// --use_fast_math. Each operation is rounded once (a multiply, then an add:
// no FMA), the division is IEEE (not a multiply by the reciprocal) and
// rintf rounds half to even like torch.round, so q is bit-identical to the
// plain version and y equal to it.

#pragma once

#include <math.h>
#include <stdint.h>

namespace requant {

__device__ __forceinline__ float requant_y(int acc, float scale, float bias,
                                           int relu) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  y = __fadd_rn(y, bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

// a y of 0 skips the division
__device__ __forceinline__ int8_t requant_q(float y, float sy) {
  const float r = y == 0.0f ? 0.0f : rintf(__fdiv_rn(y, sy));
  return (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// ---------------------------------------------------------------------------
// requant_q without a division an output: the same q for every y.
//
// With inv = fl(1 / s_y), computed once, r = fl(y * inv) is y / s_y times
// (1 + d1)(1 + d2), |d1|, |d2| <= 2^-24, and fl(y / s_y), the division's
// result, is y / s_y times (1 + d3), |d3| <= 2^-24. So for |y / s_y| <=
// 127.26, |r - fl(y / s_y)| <= 3.0001 * 2^-24 * 127.26 < 2.3e-5 < 2^-15
// (where r underflows, both are within 2^-149 of y / s_y and far from any
// half-integer). rint(r) and rint(fl(y / s_y)) can differ only where a
// half-integer lies within that distance of r: in the band, r closer than
// 2^-15 to n + 1/2, the division decides (the caller takes requant_q where
// a step's result lies outside the band).
//
// The clamp comes first: clamp(rint(v), -127, 127) = rint(clamp(v, -127.25,
// 127.25)) for every v (rint is monotone and +-127 are its fixed points), so
// r beyond +-127.25 gives +-127 without a band: fl(y / s_y) is then beyond
// +-126.5 + 2^-15 as well. fmaxf/fminf drop a NaN r, which gives -127, as
// requant_q gives for a NaN y. rint is an add of 1.5 * 2^23, exact for
// |v| < 2^22 and rounding half to even like rintf; the low byte of the sum's
// bits is the int8.
//
// With a ReLU before it and inv > 0, q = min(rint(clamp(r, 0, 128)), 127):
// the clamp is one saturating multiply by 2^-7 (exact, a NaN to 0 as the
// ReLU does), the add and the test take t = 128 s in fused multiply-adds
// (exact products, one rounding each), and the one byte that can come out
// 128 (r >= 127.5, where the reference gives 127 too) is set to 127 in the
// packed word (relu_bytes).
//
// recip_band gives inv and the band's half-width from the top (0.5 - 2^-15);
// where inv is not a finite normal number (s_y of 0, or beyond 2^+-126) the
// bound above does not hold, and the band is -1: every y takes the division.
// ---------------------------------------------------------------------------

constexpr float kRound = 0x1.8p23f;            // 1.5 * 2^23
constexpr float kBand = 0.5f - 0x1p-15f;

__device__ __forceinline__ float recip_band(float sy, float* inv) {
  *inv = __frcp_rn(sy);
  const float a = fabsf(*inv);
  return (a >= 0x1p-126f && a <= 0x1.fffffep127f) ? kBand : -1.0f;
}

// rint of the clamped fl(y * inv): the int8 in the low byte of *q; returns
// t - rint(t), which lies within the band unless the division must decide
__device__ __forceinline__ float requant_q_recip_step(float y, float inv,
                                                      int* q) {
  const float t = fminf(fmaxf(__fmul_rn(y, inv), -127.25f), 127.25f);
  const float m = __fadd_rn(t, kRound);
  *q = __float_as_int(m);
  return __fsub_rn(t, __fsub_rn(m, kRound));
}

// the same after a ReLU of y, for inv > 0: the low byte of *q is 0..128
__device__ __forceinline__ float requant_q_recip_relu_step(float y, float inv,
                                                           int* q) {
  const float s = __saturatef(__fmul_rn(__fmul_rn(y, inv), 0x1p-7f));
  const float m = __fmaf_rn(s, 128.0f, kRound);
  *q = __float_as_int(m);
  return __fmaf_rn(s, 128.0f, -__fsub_rn(m, kRound));
}

// four packed bytes of requant_q_recip_relu_step, each 128 set to 127
__device__ __forceinline__ unsigned relu_bytes(unsigned w) {
  return w - ((w >> 7) & 0x01010101u);
}

}  // namespace requant
