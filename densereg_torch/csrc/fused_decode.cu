// Fused vote decode: the whole decode of one depth frame in one block.
//
// Replaces the TPU kernel densereg_tpu/ops/fused_decode.py::fused_decode
// (Pallas `_kernel`). Semantics oracle: densereg_torch.decode.decode_plain
// (wrapped as ops.fused_decode.fused_decode_reference). Per frame and joint:
//   1. score (hm + 1) * hm3 * valid(depth) at every head pixel;
//   2. top-k picks, score descending, ties to the lower pixel index;
//   3. at each pick: back-project the normalized depth (intrinsics rescaled
//      to the head grid), candidate = xyz + um * (0.8 - 0.8 * hm3);
//   4. weight = hm at the rounded reprojection, 0 off-image;
//   5. start at the last maximal cell of a grid^3 weighted vote, then
//      num_it Gaussian mean-shift steps (0/0 keeps the estimate).
//
// Bound: memory. Per frame the kernel must read hm, hm3 and the depth in
// full, (2J + 1) * hw * 4 bytes, plus 6 gathered floats at each of the k*J
// picks (um x3, depth, hm3; hm at the reprojection). At b=256, 32x32 heads,
// J=16 that is about 34.6 MB: 10 us at 3.35 TB/s. The compute is small.
//
// Design. One block per frame, one warp per joint (J <= 32). A warp owns
// its joint's whole top-k, so the merge needs shuffles only, with no
// shared-memory round or block barrier, and the J warps of a block share
// the frame's depth row through L1. Each lane keeps a running top-8 of
// (score, index) in registers over its strided share of the pixels, so no
// (J, hw) plane is ever resident and the same kernel serves 32x32, 64x64
// and 128x128 heads; the warp then merges the lane lists in k rounds of a
// shuffle butterfly. The 3J-channel um volume is never streamed: only the
// k*J picks are gathered. The vote grid and the mean shift work on k
// candidates, so one lane per joint does them. Every input is addressed
// through explicit (b, h, w, c) element strides, so the NHWC-shaped views of
// the network's NCHW heads need no copy; lanes walk consecutive pixels,
// which are consecutive addresses in NCHW.
//
// Numerics: build without --use_fast_math and with --fmad=false. The
// float -> int rounding of a reprojection decides which pixel's weight a
// candidate gets, and the mean shift magnifies a last-bit change in the
// Gaussian weight of a far candidate, so the arithmetic repeats the plain
// version's operation by operation, in its order: IEEE division, expf, no
// contraction into FMAs, candidate sums from first to last. (The plain
// version run on the CPU is the oracle: PyTorch's CUDA kernels divide by a
// Python scalar through its reciprocal, and their results drift ~1e-5.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxJoints = 32;
constexpr int kList = 8;          // running list per lane; num_pt <= kList
constexpr float kDRange = 300.0f;
constexpr float kPoseNorm = 100.0f;
constexpr float kMaxDist3D = 0.8f;
constexpr unsigned kFull = 0xffffffffu;

struct View4 {  // element strides of a (b, h, w, c) float32 view
  const float* p;
  long long sb, sh, sw, sc;
  __device__ __forceinline__ float at(int b, int y, int x, int c) const {
    return p[b * sb + y * sh + x * sw + c * sc];
  }
};

// (score descending, index ascending): lax.top_k's order
__device__ __forceinline__ bool better(float s, int i, float t, int k) {
  return s > t || (s == t && i < k);
}

__global__ void __launch_bounds__(kMaxJoints * 32)
fused_decode_kernel(View4 hm, View4 hm3, View4 um, View4 dm,
                    const float* __restrict__ cfgs,
                    const float* __restrict__ coms, float* __restrict__ out,
                    int h, int w, int J, int num_pt, int num_it,
                    float inv_sigma, int grid, float grid_hi) {
  __shared__ float s_can[kMaxJoints][kList][4];  // x, y, z, weight

  const int b = blockIdx.x;
  const int j = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hw = h * w;

  const float* cfg = cfgs + b * 6;
  const float* com = coms + b * 3;
  // geometry.scale_cfg to the head grid
  const float w_ratio = cfg[4] / (float)w;
  const float h_ratio = cfg[5] / (float)h;
  const float fx = cfg[0] / w_ratio;
  const float fy = cfg[1] / h_ratio;
  const float cx = cfg[2] / w_ratio;
  const float cy = cfg[3] / h_ratio;
  const float com_x = com[0], com_y = com[1], com_z = com[2];

  // 1-2a. this lane's running top list
  float ts[kList];
  int ti[kList];
#pragma unroll
  for (int k = 0; k < kList; ++k) {
    ts[k] = -INFINITY;
    ti[k] = INT32_MAX;
  }
  for (int p = lane; p < hw; p += 32) {
    const int y = p / w;
    const int x = p - y * w;
    const float valid = dm.at(b, y, x, 0) < -0.99f ? 0.0f : 1.0f;
    const float s = (hm.at(b, y, x, j) + 1.0f) * hm3.at(b, y, x, j) * valid;
    if (!better(s, p, ts[kList - 1], ti[kList - 1])) continue;
    bool placed = false;
#pragma unroll
    for (int k = kList - 1; k > 0; --k) {
      if (!placed) {
        if (better(s, p, ts[k - 1], ti[k - 1])) {
          ts[k] = ts[k - 1];
          ti[k] = ti[k - 1];
        } else {
          ts[k] = s;
          ti[k] = p;
          placed = true;
        }
      }
    }
    if (!placed) {
      ts[0] = s;
      ti[0] = p;
    }
  }

  // 2b. merge the lane lists: each round every lane learns the best head;
  // its owner pops it (pixel indices are unique across lanes)
  int pick = 0;
  for (int r = 0; r < num_pt; ++r) {
    float bs = ts[0];
    int bi = ti[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == r) pick = bi;
    if (ti[0] == bi) {
#pragma unroll
      for (int k = 0; k < kList - 1; ++k) {
        ts[k] = ts[k + 1];
        ti[k] = ti[k + 1];
      }
      ts[kList - 1] = -INFINITY;
      ti[kList - 1] = INT32_MAX;
    }
  }

  // 3-4. lane n builds candidate n and its reprojection weight
  if (lane < num_pt) {
    const int y = pick / w;
    const int x = pick - y * w;
    const float d = dm.at(b, y, x, 0);
    const float min_depth = com_z - kDRange * 0.5f;
    const float max_depth = com_z + kDRange * 0.5f;
    const float zz = d < -0.99f ? max_depth : d * kDRange + min_depth;
    const float xx = ((float)x - cx) * zz / fx;
    const float yy = ((float)y - cy) * zz / fy;
    const float dist = kMaxDist3D - hm3.at(b, y, x, j) * kMaxDist3D;
    const float can_x = (xx - com_x) / kPoseNorm + um.at(b, y, x, 3 * j) * dist;
    const float can_y =
        (yy - com_y) / kPoseNorm + um.at(b, y, x, 3 * j + 1) * dist;
    const float can_z =
        (zz - com_z) / kPoseNorm + um.at(b, y, x, 3 * j + 2) * dist;

    const float x_mm = can_x * kPoseNorm + com_x;
    const float y_mm = can_y * kPoseNorm + com_y;
    const float z_mm = can_z * kPoseNorm + com_z;
    // truncation toward zero, saturating, NaN -> 0 (XLA's convert)
    const int uu = __float2int_rz(x_mm * fx / z_mm + cx + 0.5f);
    const int vv = __float2int_rz(y_mm * fy / z_mm + cy + 0.5f);
    float wgt = 0.0f;
    if (uu >= 0 && uu < w && vv >= 0 && vv < h) wgt = hm.at(b, vv, uu, j);
    s_can[j][lane][0] = can_x;
    s_can[j][lane][1] = can_y;
    s_can[j][lane][2] = can_z;
    s_can[j][lane][3] = wgt;
  }
  __syncwarp();
  if (lane != 0) return;

  // 5. vote-grid start: the last maximal cell, best starting at -1
  const float (*can)[4] = s_can[j];
  const float nq = (float)(grid / 2);
  int cell[kList];
  for (int n = 0; n < num_pt; ++n) {
    int q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)  // fmaxf maps NaN to 0, as XLA's clip+convert
      q[c] = __float2int_rz(fminf(fmaxf((can[n][c] + 1.0f) * nq, 0.0f), grid_hi));
    cell[n] = (q[0] * grid + q[1]) * grid + q[2];
  }
  float best = -1.0f;
  int best_cell = 0;
  const int cells = grid * grid * grid;
  for (int c = 0; c < cells; ++c) {
    float votes = 0.0f;
    for (int n = 0; n < num_pt; ++n)
      if (cell[n] == c) votes += can[n][3];
    if (votes >= best) {
      best = votes;
      best_cell = c;
    }
  }
  float ax = (float)(best_cell / (grid * grid)) / nq - 1.0f + 0.5f / nq;
  float ay = (float)((best_cell / grid) % grid) / nq - 1.0f + 0.5f / nq;
  float az = (float)(best_cell % grid) / nq - 1.0f + 0.5f / nq;

  for (int it = 0; it < num_it; ++it) {
    float den = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    for (int n = 0; n < num_pt; ++n) {
      const float dx = can[n][0] - ax;
      const float dy = can[n][1] - ay;
      const float dz = can[n][2] - az;
      const float s = expf(inv_sigma * (dx * dx + dy * dy + dz * dz)) * can[n][3];
      nx += can[n][0] * s;
      ny += can[n][1] * s;
      nz += can[n][2] * s;
      den += s;
    }
    if (den > 0.0f) {
      ax = nx / den;
      ay = ny / den;
      az = nz / den;
    }
  }
  float* o = out + ((long long)b * J + j) * 3;
  o[0] = ax;
  o[1] = ay;
  o[2] = az;
}

}  // namespace

// strides: 16 element strides, (b, h, w, c) of hm, hm3, um and dm in turn.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_decode_launch(const float* hm, const float* hm3,
                                   const float* um, const float* dm,
                                   const long long* strides,
                                   const float* cfgs, const float* coms,
                                   float* out, int b, int h, int w, int J,
                                   int num_pt, int num_it, float inv_sigma,
                                   int grid, float grid_hi, void* stream) {
  const float* ptrs[4] = {hm, hm3, um, dm};
  View4 v[4];
  for (int i = 0; i < 4; ++i) {
    v[i].p = ptrs[i];
    v[i].sb = strides[4 * i + 0];
    v[i].sh = strides[4 * i + 1];
    v[i].sw = strides[4 * i + 2];
    v[i].sc = strides[4 * i + 3];
  }
  fused_decode_kernel<<<b, 32 * J, 0, (cudaStream_t)stream>>>(
      v[0], v[1], v[2], v[3], cfgs, coms, out, h, w, J, num_pt, num_it,
      inv_sigma, grid, grid_hi);
  return (int)cudaGetLastError();
}
