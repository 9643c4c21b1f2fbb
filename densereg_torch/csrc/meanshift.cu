// Weighted mean shift from a vote-grid start, one thread per problem.
//
// Replaces the TPU kernel
// densereg_tpu/ops/meanshift_pallas.py::weighted_mean_shift_pallas (Pallas
// `_kernel`). Semantics oracle: densereg_torch.decode.weighted_mean_shift.
// For each of the P = b * J problems, with n candidates c_i and weights w_i:
//   1. quantize each candidate to a grid^3 cell over [-1, 1]^3, sum the
//      weights per cell, and start at the center of the LAST maximal cell
//      (cells in row-major order, ties kept with >=);
//   2. num_it Gaussian steps: s_i = exp(inv_sigma * |c_i - x|^2) * w_i,
//      x = sum(s_i c_i) / sum(s_i); where sum(s_i) is not positive (all
//      weights 0) the center is kept.
//
// Bound: operations, and small ones. A problem reads 4n floats and writes
// 3; it does about 64 n compares for the vote and 20 n operations a step.
// At the serving shape (P = 256 * 16, n = 5) that is a few microseconds of
// memory traffic, below a launch's own cost.
//
// Design: the TPU kernel put the problems on the 128 vector lanes and
// padded the last tile with weight 1. Here one thread takes one problem,
// with its n candidates in registers (n is a template parameter, 1 to 8),
// so nothing is padded and no lanes talk to each other; blocks of 128
// threads cover P. The vote scans the grid^3 cells in order and sums, in
// candidate order, the weights that fall into each, as the plain version's
// one-hot sum does.
//
// Numerics: build with --fmad=false and without --use_fast_math: IEEE
// division, expf, candidate sums from first to last, no contraction.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int N>
__global__ void __launch_bounds__(128)
meanshift_kernel(const float* __restrict__ cans, const float* __restrict__ w,
                 float* __restrict__ out, int P, int num_it, float inv_sigma,
                 int grid, float grid_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float cx[N], cy[N], cz[N], cw[N];
  int cell[N];
  const float nq = (float)(grid / 2);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* c = cans + ((long long)p * N + n) * 3;
    cx[n] = c[0];
    cy[n] = c[1];
    cz[n] = c[2];
    cw[n] = w[(long long)p * N + n];
    // fmaxf maps NaN to 0, as nan_to_num before the clip
    const int qx = __float2int_rz(fminf(fmaxf((cx[n] + 1.0f) * nq, 0.0f), grid_hi));
    const int qy = __float2int_rz(fminf(fmaxf((cy[n] + 1.0f) * nq, 0.0f), grid_hi));
    const int qz = __float2int_rz(fminf(fmaxf((cz[n] + 1.0f) * nq, 0.0f), grid_hi));
    cell[n] = (qx * grid + qy) * grid + qz;
  }

  // 1. vote: every cell in row-major order, best starting at -1 (an empty
  // cell votes 0, so the best is never below 0)
  float best = -1.0f;
  int best_cell = 0;
  const int cells = grid * grid * grid;
  for (int c = 0; c < cells; ++c) {
    float votes = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (cell[n] == c) votes += cw[n];
    if (votes >= best) {
      best = votes;
      best_cell = c;
    }
  }
  float ax = (float)(best_cell / (grid * grid)) / nq - 1.0f + 0.5f / nq;
  float ay = (float)((best_cell / grid) % grid) / nq - 1.0f + 0.5f / nq;
  float az = (float)(best_cell % grid) / nq - 1.0f + 0.5f / nq;

  // 2. mean-shift steps
  for (int it = 0; it < num_it; ++it) {
    float den = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float dx = cx[n] - ax;
      const float dy = cy[n] - ay;
      const float dz = cz[n] - az;
      const float s = expf(inv_sigma * (dx * dx + dy * dy + dz * dz)) * cw[n];
      nx += cx[n] * s;
      ny += cy[n] * s;
      nz += cz[n] * s;
      den += s;
    }
    if (den > 0.0f) {
      ax = nx / den;
      ay = ny / den;
      az = nz / den;
    }
  }
  out[(long long)p * 3 + 0] = ax;
  out[(long long)p * 3 + 1] = ay;
  out[(long long)p * 3 + 2] = az;
}

template <int N>
void launch(const float* cans, const float* w, float* out, int P, int num_it,
            float inv_sigma, int grid, float grid_hi, cudaStream_t stream) {
  meanshift_kernel<N><<<(P + 127) / 128, 128, 0, stream>>>(
      cans, w, out, P, num_it, inv_sigma, grid, grid_hi);
}

}  // namespace

// cans: (P, n, 3) float32, w: (P, n) float32, out: (P, 3) float32, all
// contiguous; 1 <= n <= 8. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for another n.
extern "C" int meanshift_launch(const float* cans, const float* w, float* out,
                                int P, int n, int num_it, float inv_sigma,
                                int grid, float grid_hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1: launch<1>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 2: launch<2>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 3: launch<3>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 4: launch<4>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 5: launch<5>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 6: launch<6>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 7: launch<7>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    case 8: launch<8>(cans, w, out, P, num_it, inv_sigma, grid, grid_hi, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
