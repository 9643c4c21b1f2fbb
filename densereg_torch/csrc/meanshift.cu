// Weighted mean shift from a vote-grid start, four problems a warp.
//
// Replaces the TPU kernel
// densereg_tpu/ops/meanshift_pallas.py::weighted_mean_shift_pallas (Pallas
// `_kernel`). Semantics oracle: densereg_torch.decode.weighted_mean_shift.
// For each of the P = b * J problems, with n candidates c_i and weights w_i:
//   1. quantize each candidate to a grid^3 cell over [-1, 1]^3, sum the
//      weights per cell, and start at the center of the LAST maximal cell
//      (cells in row-major order; a NaN vote is maximal, as in argmax);
//   2. num_it Gaussian steps: s_i = exp(inv_sigma * |c_i - x|^2) * w_i,
//      x = sum(s_i c_i) / sum(s_i); where sum(s_i) is not positive (all
//      weights 0) the center is kept.
//
// Bound: operations, and small ones. A problem reads 4n floats and writes
// 3; it does about 64 n compares for the dense vote and 20 n operations a
// step. At the serving shape (P = 256 * 16, n = 5) that is 0.11 us of
// memory traffic, below a launch's own cost: what the kernel can shorten is
// its critical path, one problem's chain.
//
// Design: the TPU kernel put the problems on the 128 vector lanes. Here an
// 8-lane segment takes one problem, four problems a warp and blocks of 128
// threads: P = 4,096 spreads over 256 blocks, all SMs. Lane i loads
// candidate i (the segment reads its problem's 4n floats in one go), and
// the segment runs the shared tail of vote_meanshift.cuh: the vote over the
// occupied cells only, O(n^2) instead of 64 n, and the mean shift in
// registers unrolled over n (a template parameter, 1 to 8), its n
// exponentials a step independent.

#include <cuda_runtime.h>

#include "vote_meanshift.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int N>
__global__ void __launch_bounds__(kThreads)
meanshift_kernel(const float* __restrict__ cans, const float* __restrict__ w,
                 float* __restrict__ out, long long P, int num_it,
                 float inv_sigma, int grid, float grid_hi) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long p = g / vote_meanshift::kSeg;
  const int i = (int)(g % vote_meanshift::kSeg);
  // lanes past P still take part in the segment's shuffles, on zeros
  float cx = 0.0f, cy = 0.0f, cz = 0.0f, cw = 0.0f;
  if (p < P && i < N) {
    const float* c = cans + (p * N + i) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
    cw = w[p * N + i];
  }
  const float3 r = vote_meanshift::run<N>(kFull, cx, cy, cz, cw, num_it,
                                          inv_sigma, grid, grid_hi);
  if (p < P && i < 3) out[p * 3 + i] = i == 0 ? r.x : (i == 1 ? r.y : r.z);
}

template <int N>
void launch(const float* cans, const float* w, float* out, long long P,
            int num_it, float inv_sigma, int grid, float grid_hi,
            cudaStream_t stream) {
  const long long threads = P * vote_meanshift::kSeg;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  meanshift_kernel<N><<<blocks, kThreads, 0, stream>>>(
      cans, w, out, P, num_it, inv_sigma, grid, grid_hi);
}

}  // namespace

// cans: (P, n, 3) float32, w: (P, n) float32, out: (P, 3) float32, all
// contiguous; 1 <= n <= 8. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for another n.
extern "C" int meanshift_launch(const float* cans, const float* w, float* out,
                                long long P, int n, int num_it,
                                float inv_sigma, int grid, float grid_hi,
                                void* stream) {
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
