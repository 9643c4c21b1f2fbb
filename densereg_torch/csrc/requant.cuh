// The requantisation epilogue that the int8 convolutions share: K3
// (int8_gemm.cu) and the depthwise convolution (int8_dwconv.cu). Semantics
// oracle: densereg_torch.ops.int8_gemm.requant_reference.
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

}  // namespace requant
