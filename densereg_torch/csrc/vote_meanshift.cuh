// Vote-grid start and weighted mean shift of one problem held by an 8-lane
// segment of a warp: the tail that the fused decode (fused_decode.cu, K1)
// and the mean shift alone (meanshift.cu, K2) share. Semantics oracle:
// densereg_torch.decode.weighted_mean_shift (and _vote_grid_init), itself
// the JAX package's decode.weighted_mean_shift.
//
// Lane i of the segment holds candidate i (i < N <= 8); the kernels build
// or load the candidates that way, in parallel. The tail then gathers all N
// into registers on every lane of the segment (4N shuffles, issued at
// once) and runs there, unrolled over N. One candidate a lane with
// shuffled sums in every step measured slower on the H100 (the mean shift
// alone 6.8 against 4.9 us at b*J = 4,096, both with expf): each step
// waits on 4N dependent shuffles, while here the N exponentials of a step
// are independent instructions.
//
// The plain version scores every one of the grid^3 cells with a one-hot
// sum; here only the occupied cells and one empty cell compete, O(N^2)
// instead of grid^3 * N:
//
//   - the vote of an occupied cell is the dense sum restricted to what can
//     change it: from 0, in candidate order, w_t where candidate t lies in
//     the cell and w_t * 0 where it does not. w_t * 0 is 0 for a finite
//     weight and NaN for a NaN or infinite one, so a NaN or infinite weight
//     makes every other cell's vote NaN, as the one-hot product does;
//   - every empty cell votes the sum of the w_t * 0 alone (0, or NaN), and
//     the last empty cell stands for all of them;
//   - the start is the cell of the largest vote, NaN above every number
//     (argmax's rule), ties to the larger cell index (the plain version
//     takes the last maximal cell). So a negative best occupied vote loses
//     to the last empty cell, and an occupied vote of exactly 0 ties with
//     the empty cells, the later index winning.
//
// Mean shift: s_t = exp(inv_sigma * d_t^2) * w_t, the sums in candidate
// order, one IEEE division a coordinate; a weight sum that is not positive
// (all weights 0, or NaN) keeps the centre.
//
// Numerics: built with --fmad=false, -ftz=true and without
// --use_fast_math: IEEE division, no contraction into FMAs, sums in
// candidate order, and every subnormal float32 input or result of a float32
// operation flushed to a zero of its sign, as XLA computes on the CPU and
// the TPU (and the plain version, through flush_subnormals): a Gaussian
// weight that underflows below 2^-126 adds nothing, and a weight sum made
// only of such weights is 0, so the centre stays. The exponential's
// conversion from double is flushed explicitly (flush_subnormal), as are
// the candidates and weights the segment gathers. The
// exponential is taken in double of the float argument and rounded to
// float, i.e. correctly rounded, where CUDA's expf is within 2 ulp: the
// CPU's float exp, the oracle's, is within 1 ulp, and ten steps magnified
// a 1-ulp difference to 1.1e-5 normalized on one joint of a chip_smoke.py
// scene with expf (2.6e-6 with this exp). It costs K2 4 us (4.9 to 9.0 at
// b*J = 4,096) and K1 1.4 us at b = 256.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vote_meanshift {

constexpr int kSeg = 8;  // lanes a problem; at most kSeg candidates

// v, or a zero of v's sign where v is subnormal (exponent bits 0)
__device__ __forceinline__ float flush_subnormal(float v) {
  const unsigned u = __float_as_uint(v);
  return __uint_as_float((u & 0x7f800000u) ? u : (u & 0x80000000u));
}

// (vote a of cell ca) beats (vote b of cell cb): NaN above every number,
// ties to the larger cell index
__device__ __forceinline__ bool vote_better(float a, int ca, float b, int cb) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ca > cb);
  return a > b || (a == b && ca > cb);
}

// One problem of N candidates, candidate t on lane t of the calling lane's
// 8-lane segment. `mask` names the lanes of the warp that make this call:
// whole segments, all with the same N, num_it and grid. Lanes at or past N
// pass anything. Returns the centre, the same on every lane of the segment.
template <int N>
__device__ __forceinline__ float3 run(unsigned mask, float cx, float cy,
                                      float cz, float cw, int num_it,
                                      float inv_sigma, int grid,
                                      float grid_hi) {
  static_assert(N >= 1 && N <= kSeg, "1 to 8 candidates");
  float x[N], y[N], z[N], w[N];
#pragma unroll
  for (int t = 0; t < N; ++t) {
    x[t] = flush_subnormal(__shfl_sync(mask, cx, t, kSeg));
    y[t] = flush_subnormal(__shfl_sync(mask, cy, t, kSeg));
    z[t] = flush_subnormal(__shfl_sync(mask, cz, t, kSeg));
    w[t] = flush_subnormal(__shfl_sync(mask, cw, t, kSeg));
  }
  const float nq = (float)(grid / 2);

  // 1. each candidate's cell; fmaxf maps NaN to 0, as the plain version's
  // nan_to_num before the clip
  int cell[N];
  float off_cell[N];  // w_t * 0: 0, or NaN for a NaN or inf weight
  float e = 0.0f;     // an empty cell's vote
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const int qx = __float2int_rz(fminf(fmaxf((x[t] + 1.0f) * nq, 0.0f), grid_hi));
    const int qy = __float2int_rz(fminf(fmaxf((y[t] + 1.0f) * nq, 0.0f), grid_hi));
    const int qz = __float2int_rz(fminf(fmaxf((z[t] + 1.0f) * nq, 0.0f), grid_hi));
    cell[t] = (qx * grid + qy) * grid + qz;
    off_cell[t] = w[t] * 0.0f;
    e = e + off_cell[t];
  }

  // 2. the best occupied cell
  float bv = 0.0f;
  int bc = -1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = 0.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) v = v + (cell[t] == cell[i] ? w[t] : off_cell[t]);
    if (i == 0 || vote_better(v, cell[i], bv, bc)) {
      bv = v;
      bc = cell[i];
    }
  }

  // 3. against the last empty cell: at most N occupied cells lie above it
  int last = grid * grid * grid - 1;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    bool occupied = false;
#pragma unroll
    for (int t = 0; t < N; ++t) occupied = occupied || cell[t] == last;
    if (!occupied) break;
    --last;
  }
  if (last >= 0 && vote_better(e, last, bv, bc)) bc = last;

  float ax = (float)(bc / (grid * grid)) / nq - 1.0f + 0.5f / nq;
  float ay = (float)((bc / grid) % grid) / nq - 1.0f + 0.5f / nq;
  float az = (float)(bc % grid) / nq - 1.0f + 0.5f / nq;

  // 4. mean-shift steps
  for (int it = 0; it < num_it; ++it) {
    float s[N];
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const float dx = x[t] - ax;
      const float dy = y[t] - ay;
      const float dz = z[t] - az;
      const float arg = inv_sigma * (dx * dx + dy * dy + dz * dz);
      s[t] = flush_subnormal((float)exp((double)arg)) * w[t];
    }
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, den = 0.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      nx = nx + x[t] * s[t];
      ny = ny + y[t] * s[t];
      nz = nz + z[t] * s[t];
      den = den + s[t];
    }
    if (den > 0.0f) {
      ax = nx / den;
      ay = ny / den;
      az = nz / den;
    }
  }
  return make_float3(ax, ay, az);
}

}  // namespace vote_meanshift
