// Fused vote decode: the whole decode of a frame's joints, four joints a
// block.
//
// Replaces the TPU kernel densereg_tpu/ops/fused_decode.py::fused_decode
// (Pallas `_kernel`). Semantics oracle: densereg_torch.decode.decode_plain
// (wrapped as ops.fused_decode.fused_decode_reference). Per frame and joint:
//   1. score (hm + 1) * hm3 * valid(depth) at every head pixel;
//   2. top-k picks, score descending, ties to the lower pixel index, NaN
//      above every number and -0 equal to 0 (torch.sort's order);
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
// Design. One block a frame with each lane walking its pixels one
// dependent load at a time, and one lane a joint running the tail, is
// bound by that serial chain, not the bytes (39 us for a lone frame on an
// H100). Here:
//   - grid (frame, joint group), four warps a block, one warp a joint: a
//     frame spans J/4 blocks and b = 256 gives 1,024 small blocks, one wave
//     (64 registers and 21 KB of shared memory a block: 8 blocks an SM);
//   - the block stages up to 2,048 pixels of the frame at a time in shared
//     memory: the depth's validity once for its four joints, then the four
//     joints' scores in tiles of 4 pixels x 4 joints, from hm and hm3 each
//     read 16 bytes a load along whichever axis has stride 1: pixels (the
//     NHWC view of an NCHW head) or channels (a channels-last head, J % 4
//     == 0). The heads arrive in both layouts, and mixed: the int8 net's
//     are all channels-last, while the float nets hand over a channels-last
//     hm beside NCHW hm3 and um (as their convolutions return them on the
//     card). Any other strides take scalar loads (strided). Scores are
//     stored as order keys (unsigned, NaN above +inf, -0 as 0), so the scan
//     compares integers;
//   - each lane keeps a running top-k (k = num_pt, a template parameter)
//     of (key, index), packed in 64 bits, in registers over its strided
//     share of the chunk in shared memory. A first pass takes each lane's
//     maximum; the k-th best of those is a floor under the chunk's k-th
//     best pixel, and the second pass inserts, branch-free, only where some
//     lane has a pixel at or above it. (A lane-by-lane early exit
//     diverges: some lane of the warp inserts at nearly every step, so the
//     warp runs the insertion for every pixel; the scan and merge took
//     10.8 of 32 us at b = 256 that way.) The warp merges the lane lists
//     in k rounds of a shuffle butterfly;
//   - lane n < k builds candidate n and its weight (gathers at the picks)
//     into shared memory, and one warp runs the shared tail of
//     vote_meanshift.cuh for the block's four joints at once, one 8-lane
//     segment a joint (a tail a warp would take a quarter of the SM's issue
//     slots at b = 256).
// Every input is addressed through explicit (b, h, w, c) element strides,
// so no served layout is copied.
//
// What holds it back (H100, b = 256, 32x32, J = 16): the staging alone
// runs at about the byte bound (11.8 us), but the 1,024 blocks are all
// resident at once and move in step, so the scan and merge, the gathers
// at the picks and the tail follow it with the memory idle; the whole
// takes about 3x the bound. Overlapping them needs a kernel that stages
// one work item while it decodes the last (persistent, double-buffered).
//
// Numerics: build without --use_fast_math and with --fmad=false and
// -ftz=true (subnormal float32 values flushed to zero, as XLA and the
// plain version's flush_subnormals compute; ops/_build.py). The
// float -> int rounding of a reprojection decides which pixel's weight a
// candidate gets, and the mean shift magnifies a last-bit change in the
// Gaussian weight of a far candidate, so the arithmetic repeats the plain
// version's operation by operation, in its order: IEEE division, a
// correctly rounded exp (vote_meanshift.cuh says why), no contraction into
// FMAs, candidate sums from first to last. (The plain version run on the
// CPU is the oracle: PyTorch's CUDA kernels divide by a Python scalar
// through its reciprocal, and their results drift ~1e-5.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vote_meanshift.cuh"

namespace {

constexpr int kWarps = 4;        // joints a block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2048;     // pixels staged at a time, at most
constexpr float kDRange = 300.0f;
constexpr float kPoseNorm = 100.0f;
constexpr float kMaxDist3D = 0.8f;
constexpr unsigned kFull = 0xffffffffu;

// staging paths: (hm read along channels) + 2 (hm3 read along channels),
// or kStrided
enum Path { kPlanes = 0, kHmPixels = 1, kHm3Pixels = 2, kPixels = 3,
            kStrided = 4 };

struct View4 {  // element strides of a (b, h, w, c) float32 view
  const float* p;
  long long sb, sh, sw, sc;
  __device__ __forceinline__ const float* ptr(int b, int y, int x,
                                              int c) const {
    return p + (b * sb + y * sh + x * sw + c * sc);
  }
  __device__ __forceinline__ float at(int b, int y, int x, int c) const {
    return *ptr(b, y, x, c);
  }
};

// order key of a score: larger score, larger key; NaN above +inf; -0 = 0
__device__ __forceinline__ unsigned score_key(float s) {
  if (isnan(s)) return kFull;
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key, pixel) packed so that the larger value is the better pick: key
// descending, index ascending (torch.sort's stable order); 0 is below
// every pixel's (no score has key 0)
__device__ __forceinline__ unsigned long long pack(unsigned key, int idx) {
  return ((unsigned long long)key << 32) | (unsigned)~idx;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ unsigned key_at(float hm, float hm3, float valid) {
  return score_key((hm + 1.0f) * hm3 * valid);
}

// Which axis of hm or hm3 the staging reads 16 bytes at a time along:
// pixels (kP: pixel stride 1, the NHWC view of an NCHW head) or channels
// (kC: channel stride 1, a channels-last head).
enum Orient { kP = 0, kC = 1 };

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// One tensor's part of a staging tile, the 4 pixels from pix0 of joints j0
// .. j0 + 3 of frame b: kP loads r[jj] = 4 pixels of joint jj (jj < nj),
// kC loads r[pp] = 4 joints of pixel pp (nj == 4).
template <int O>
__device__ __forceinline__ void load_tile(const View4& v, int b, int j0,
                                          int nj, int pix0, int w,
                                          float4 (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (O == kP) {
      if (i < nj) r[i] = load4(v.p + (b * v.sb + (j0 + i) * v.sc + pix0));
    } else {
      const int y = (pix0 + i) / w;
      r[i] = load4(v.ptr(b, y, pix0 + i - y * w, j0));
    }
  }
}

// element (joint jj, pixel pp) of a loaded tile
template <int O>
__device__ __forceinline__ float tile_at(const float4 (&r)[4], int jj,
                                         int pp) {
  return O == kP ? comp(r[jj], pp) : comp(r[pp], jj);
}

// Stage the keys of joints j0 .. j0 + nj - 1 at the chunk's n pixels from
// c0: s_key[jj * chunk + p]. kPixels: four joints of a pixel a load of
// each; the mixed paths and kPlanes: 4 x 4 tiles, hm read along its
// orientation PATH & 1, hm3 along PATH >> 1 (n % 4 == 0); kStrided: one
// scalar load of each a key.
template <int PATH>
__device__ __forceinline__ void stage_keys(const View4& hm, const View4& hm3,
                                           const float* s_valid,
                                           unsigned* s_key, int chunk, int b,
                                           int j0, int nj, int c0, int n,
                                           int w) {
  if (PATH == kStrided) {
    for (int it = threadIdx.x; it < nj * n; it += kThreads) {
      const int jj = it / n;
      const int p = it - jj * n;
      const int y = (c0 + p) / w;
      const int x = c0 + p - y * w;
      s_key[jj * chunk + p] = key_at(hm.at(b, y, x, j0 + jj),
                                     hm3.at(b, y, x, j0 + jj), s_valid[p]);
    }
    return;
  }
  if (PATH == kPixels) {
    // both along the channels: a warp takes 128 pixels, and each of a
    // thread's four loads of a tensor reads 32 consecutive pixels of the
    // warp (4x4 tiles of 4 consecutive pixels would put the lanes of a
    // load 256 bytes apart: 42 against 33 us at b = 256)
    const int lane = threadIdx.x & 31;
    for (int g = (threadIdx.x >> 5) * 128; g < n; g += 4 * kThreads) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = g + 32 * i + lane;
        if (p < n) {
          const int y = (c0 + p) / w;
          const int x = c0 + p - y * w;
          a[i] = load4(hm.ptr(b, y, x, j0));
          c[i] = load4(hm3.ptr(b, y, x, j0));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = g + 32 * i + lane;
        if (p < n) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s_key[jj * chunk + p] =
                key_at(comp(a[i], jj), comp(c[i], jj), s_valid[p]);
        }
      }
    }
    return;
  }
  constexpr int HM = PATH & 1, HM3 = PATH >> 1;
  for (int t = threadIdx.x; t < (n >> 2); t += kThreads) {
    float4 a[4], c[4];
    load_tile<HM>(hm, b, j0, nj, c0 + 4 * t, w, a);
    load_tile<HM3>(hm3, b, j0, nj, c0 + 4 * t, w, c);
    const float4 v = reinterpret_cast<const float4*>(s_valid)[t];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj < nj)
        reinterpret_cast<uint4*>(s_key + jj * chunk)[t] = make_uint4(
            key_at(tile_at<HM>(a, jj, 0), tile_at<HM3>(c, jj, 0), v.x),
            key_at(tile_at<HM>(a, jj, 1), tile_at<HM3>(c, jj, 1), v.y),
            key_at(tile_at<HM>(a, jj, 2), tile_at<HM3>(c, jj, 2), v.z),
            key_at(tile_at<HM>(a, jj, 3), tile_at<HM3>(c, jj, 3), v.w));
    }
  }
}

template <int K, int PATH>
__global__ void __launch_bounds__(kThreads, 8)
fused_decode_kernel(View4 hm, View4 hm3, View4 um, View4 dm,
                    const float* __restrict__ cfgs,
                    const float* __restrict__ coms, float* __restrict__ out,
                    int h, int w, int J, int chunk, int num_it,
                    float inv_sigma, int grid, float grid_hi) {
  extern __shared__ __align__(16) unsigned s_mem[];
  float* s_valid = reinterpret_cast<float*>(s_mem);  // [chunk]
  unsigned* s_key = s_mem + chunk;                   // [kWarps][chunk]
  __shared__ float s_cam[7];  // fx, fy, cx, cy on the head grid; com
  __shared__ float4 s_can[kWarps][K];  // candidate x, y, z and weight

  const int b = blockIdx.x;
  const int j0 = blockIdx.y * kWarps;
  const int nj = min(kWarps, J - j0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = j0 + warp;
  const int hw = h * w;

  if (threadIdx.x == 0) {  // geometry.scale_cfg to the head grid
    const float* cfg = cfgs + b * 6;
    const float w_ratio = cfg[4] / (float)w;
    const float h_ratio = cfg[5] / (float)h;
    s_cam[0] = cfg[0] / w_ratio;
    s_cam[1] = cfg[1] / h_ratio;
    s_cam[2] = cfg[2] / w_ratio;
    s_cam[3] = cfg[3] / h_ratio;
    for (int c = 0; c < 3; ++c) s_cam[4 + c] = coms[b * 3 + c];
  }

  // 1-2a. chunk by chunk: stage, then each lane's running top list,
  // descending
  unsigned long long top[K];
#pragma unroll
  for (int k = 0; k < K; ++k) top[k] = 0ull;
  for (int c0 = 0; c0 < hw; c0 += chunk) {
    const int n = min(chunk, hw - c0);
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const int y = (c0 + p) / w;
      s_valid[p] = dm.at(b, y, c0 + p - y * w, 0) < -0.99f ? 0.0f : 1.0f;
    }
    __syncthreads();
    stage_keys<PATH>(hm, hm3, s_valid, s_key, chunk, b, j0, nj, c0, n, w);
    __syncthreads();
    if (warp < nj) {
      // the chunk's k-th best pixel is no worse than the k-th best of the
      // 32 lane maxima (k lanes each hold a pixel at least that good), so
      // only pixels at or above it can enter a list
      const unsigned* keys = s_key + warp * chunk;
      unsigned long long m = 0ull;
#pragma unroll 4
      for (int p = lane; p < n; p += 32) {
        const unsigned long long v = pack(keys[p], c0 + p);
        m = v > m ? v : m;
      }
#pragma unroll
      for (int r = 0; r < K - 1; ++r)
        if (m == warp_max(m)) m = 0ull;  // the values are distinct
      const unsigned long long floor = warp_max(m);
      // a branch-free insertion, taken only where some lane of the warp
      // has a pixel at or above the floor: a lane-by-lane early exit would
      // diverge on nearly every pixel
      for (int base = 0; base < n; base += 32) {  // the same steps on every lane
        const int p = base + lane;
        unsigned long long v = p < n ? pack(keys[p], c0 + p) : 0ull;
        const bool in = p < n && v >= floor;
        if (!__any_sync(kFull, in)) continue;
        v = in ? v : 0ull;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const unsigned long long hi = v > top[k] ? v : top[k];
          v = v > top[k] ? top[k] : v;
          top[k] = hi;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the stage
  }

  if (warp < nj) {
    // 2b. merge the lane lists: each round every lane learns the best head;
    // its owner pops it (the packed values are unique across lanes)
    int pick = 0;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const unsigned long long best = warp_max(top[0]);
      if (lane == r) pick = (int)~(unsigned)best;
      if (top[0] == best) {
#pragma unroll
        for (int k = 0; k < K - 1; ++k) top[k] = top[k + 1];
        top[K - 1] = 0ull;
      }
    }

    // 3-4. lane n < k builds candidate n and its reprojection weight
    if (lane < K) {
      const float fx = s_cam[0], fy = s_cam[1], cx = s_cam[2], cy = s_cam[3];
      const float com_x = s_cam[4], com_y = s_cam[5], com_z = s_cam[6];
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
      s_can[warp][lane] = make_float4(can_x, can_y, can_z, wgt);
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 5. vote-grid start and mean shift: joint jj on lanes 8 jj .. 8 jj + 7
  const int jj = lane / vote_meanshift::kSeg;
  const int i = lane % vote_meanshift::kSeg;
  float4 can = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (jj < nj && i < K) can = s_can[jj][i];
  const float3 r = vote_meanshift::run<K>(kFull, can.x, can.y, can.z, can.w,
                                          num_it, inv_sigma, grid, grid_hi);
  if (jj < nj && i < 3)
    out[((long long)b * J + j0 + jj) * 3 + i] =
        i == 0 ? r.x : (i == 1 ? r.y : r.z);
}

// The orientation hm or hm3 can be read along, 16 bytes a load: kP (four
// pixels of one joint: planes of pixel stride 1), kC (four joints of one
// pixel: channel stride 1, J % 4 == 0), else -1. The stride of a dimension
// of size 1 is never used, whatever it is.
int orient(const View4& v, int b, int h, int w, int J) {
  if ((reinterpret_cast<uintptr_t>(v.p) & 15) != 0 || (h * w) % 4 != 0 ||
      (b > 1 && v.sb % 4 != 0))
    return -1;
  if ((J == 1 || v.sc % 4 == 0) && (h == 1 || v.sh == w) &&
      (w == 1 || v.sw == 1))
    return kP;
  if (J % 4 == 0 && v.sc == 1 && (h == 1 || v.sh % 4 == 0) &&
      (w == 1 || v.sw % 4 == 0))
    return kC;
  return -1;
}

template <int K>
void launch(int path, const View4* v, const float* cfgs, const float* coms,
            float* out, int b, int h, int w, int J, int num_it,
            float inv_sigma, int grid, float grid_hi, cudaStream_t stream) {
  const dim3 blocks(b, (J + kWarps - 1) / kWarps);
  // a chunk of at most kChunk pixels, a multiple of 4; 20 KB at 32x32
  const int chunk = min(kChunk, (h * w + 3) / 4 * 4);
  const size_t smem = (size_t)(1 + kWarps) * chunk * sizeof(float);
#define DENSEREG_K1_LAUNCH(P)                                                \
  fused_decode_kernel<K, P><<<blocks, kThreads, smem, stream>>>(             \
      v[0], v[1], v[2], v[3], cfgs, coms, out, h, w, J, chunk, num_it,       \
      inv_sigma, grid, grid_hi)
  switch (path) {
    case kPlanes: DENSEREG_K1_LAUNCH(kPlanes); break;
    case kHmPixels: DENSEREG_K1_LAUNCH(kHmPixels); break;
    case kHm3Pixels: DENSEREG_K1_LAUNCH(kHm3Pixels); break;
    case kPixels: DENSEREG_K1_LAUNCH(kPixels); break;
    default: DENSEREG_K1_LAUNCH(kStrided);
  }
#undef DENSEREG_K1_LAUNCH
}

}  // namespace

// strides: 16 element strides, (b, h, w, c) of hm, hm3, um and dm in turn;
// 1 <= num_pt <= 8, num_pt <= h * w. Picks the staging path from the
// layouts of hm and hm3, writes it to *path_out (0 planes, 1 hm_pixels, 2
// hm3_pixels, 3 pixels, 4 strided) and launches on `stream`. Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for another num_pt.
extern "C" int fused_decode_launch(const float* hm, const float* hm3,
                                   const float* um, const float* dm,
                                   const long long* strides,
                                   const float* cfgs, const float* coms,
                                   float* out, int b, int h, int w, int J,
                                   int num_pt, int num_it, float inv_sigma,
                                   int grid, float grid_hi, int* path_out,
                                   void* stream) {
  const float* ptrs[4] = {hm, hm3, um, dm};
  View4 v[4];
  for (int i = 0; i < 4; ++i) {
    v[i].p = ptrs[i];
    v[i].sb = strides[4 * i + 0];
    v[i].sh = strides[4 * i + 1];
    v[i].sw = strides[4 * i + 2];
    v[i].sc = strides[4 * i + 3];
  }
  const int o_hm = orient(v[0], b, h, w, J), o_hm3 = orient(v[1], b, h, w, J);
  const int path = o_hm < 0 || o_hm3 < 0 ? kStrided : o_hm + 2 * o_hm3;
  cudaStream_t s = (cudaStream_t)stream;
#define DENSEREG_K1_CASE(K)                                                  \
  case K:                                                                    \
    launch<K>(path, v, cfgs, coms, out, b, h, w, J, num_it, inv_sigma, grid, \
              grid_hi, s);                                                   \
    break;
  switch (num_pt) {
    DENSEREG_K1_CASE(1)
    DENSEREG_K1_CASE(2)
    DENSEREG_K1_CASE(3)
    DENSEREG_K1_CASE(4)
    DENSEREG_K1_CASE(5)
    DENSEREG_K1_CASE(6)
    DENSEREG_K1_CASE(7)
    DENSEREG_K1_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DENSEREG_K1_CASE
  *path_out = path;
  return (int)cudaGetLastError();
}
