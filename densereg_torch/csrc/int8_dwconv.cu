// Depthwise int8 convolution with the requantisation epilogue fused:
//
//   acc[b,y,x,c] = sum_{i,j} x_q[b, y+i-ph, x+j-pw, c] * w_q[i, j, c]  (int32)
//   y = relu?(float(acc) * scale[c] + bias[c])                       (float32)
//   q = clamp(rint(y / s_y), -127, 127) (int8)  and/or  f = y (float32 or
//   bfloat16)
//
// SAME padding, stride 1, a k x k window (k = 1, 3 or 5), NHWC of any C.
// The port's own kernel, in K3's family: the JAX package has no Pallas
// counterpart and runs the depthwise convolutions of the um_v1_lite int8
// net as XLA's grouped int8 convolution (densereg_tpu/models/layers.py:
// 237-244, feature_group_count = C); torch has no CUDA int8 grouped
// convolution and K3 takes groups == 1 only. Semantics oracle:
// densereg_torch.ops.int8_dwconv.int8_dwconv_requant_reference. The
// epilogue is K3's, operation for operation (requant.cuh).
//
// Bound: bytes. Each output takes k * k multiply-adds of one channel, so the
// tensor cores give nothing; every input byte is read about once and every
// output written once (1 byte for q, 2 or 4 for f). The design keeps device
// memory traffic at that:
//
// - A block computes a tile of up to 8 x 8 output pixels of `ipb` images
//   and `cpb` 16-channel chunks; one thread an (image, pixel, chunk). The
//   chunk is fastest, so a warp's loads and stores cover whole pixels. On
//   small maps the tile shrinks to the map and the block takes more images
//   or chunks, up to 256 threads.
// - The tile's input with its halo is staged in shared memory once
//   ((th + k - 1) x (tw + k - 1) pixels), zeros where the window leaves the
//   image (int8 0 is float 0, as the SAME padding), then every thread reads
//   its k * k taps from there.
// - Vector path: where every pixel starts at a 16-byte multiple (the layout
//   of quantize(pitch16) and of K3's q) a chunk is one 16-byte load. The
//   bytes between C and the pitch hold anything: they meet zero weights
//   (pack_dw_weight), and their outputs are never stored (q's pitch
//   excepted). Scalar path: any other strides, a byte at a time, channels
//   past C as zeros.
// - The thread's k * k weight chunks live in registers. A multiply-add is
//   a dp4a of the input word with the weight word masked to one byte: two
//   integer instructions per channel and tap.
// - Blocks with the channel chunks fastest: neighbouring blocks read the
//   same pixels' other channels, so the halo rows come from the L2.
//
// Numerics: build with --fmad=false, without -ftz and without
// --use_fast_math: the int32 sums are exact (|acc| <= k^2 * 127^2), q is
// bit-identical to the plain version and f equal to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 8;            // output rows and columns of a tile

struct Args {
  const int8_t* x;                  // NHWC activation
  long long sn, sy, sx, sc;         // its byte strides
  int vec;                          // 16-byte loads (see dw_launch)
  int B, H, W, C, cp;               // cp = C rounded up to 16
  int ph, pw;                       // SAME pads before
  const int8_t* w;                  // (k * k, cp) packed weights
  const float* scale;
  const float* bias;
  const float* s_y;
  int8_t* q;                        // (B, H, W) pixels of ldq bytes, or null
  long long ldq;
  void* f;                          // (B, H, W, C), or null
  int f_kind;                       // 0 none, 1 float32, 2 bfloat16
  int f_vec;                        // elements of f a store: 1, 4 or 8
  int relu;
  int th, tw, cpb, ipb;             // the block's tile
  int tiles_x, tiles_y, groups;     // tiles of the map, chunk groups
};

// acc[e] += x byte e * w byte e, for the 16 channels of a chunk
__device__ __forceinline__ void mac16(int* acc, const int4 xv,
                                      const int4 wv) {
  const int xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const int ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * u + b] = __dp4a(
          xs[u], (int)((unsigned)ws[u] & (0xffu << (8 * b))), acc[4 * u + b]);
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads) dw_kernel(const Args a) {
  extern __shared__ int4 tile[];    // [ipb][th + K - 1][tw + K - 1][cpb]
  const int TH = a.th + K - 1, TW = a.tw + K - 1;

  long long bid = blockIdx.x;
  const int g = (int)(bid % a.groups);
  bid /= a.groups;
  const int tx = (int)(bid % a.tiles_x);
  bid /= a.tiles_x;
  const int ty = (int)(bid % a.tiles_y);
  const int n0 = (int)(bid / a.tiles_y) * a.ipb;
  const int y0 = ty * a.th, x0 = tx * a.tw, k0 = g * a.cpb;  // k0: chunk
  const int nchunks = a.cp / 16;

  // 1. the input tile with its halo
  const int total = a.ipb * TH * TW * a.cpb;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    int r = u;
    const int ch = r % a.cpb;
    r /= a.cpb;
    const int px = r % TW;
    r /= TW;
    const int py = r % TH;
    const int n = n0 + r / TH;
    const int yy = y0 + py - a.ph, xx = x0 + px - a.pw;
    const int chunk = k0 + ch;
    int4 v = make_int4(0, 0, 0, 0);
    if (n < a.B && (unsigned)yy < (unsigned)a.H &&
        (unsigned)xx < (unsigned)a.W && chunk < nchunks) {
      const int8_t* p = a.x + n * a.sn + yy * a.sy + xx * a.sx;
      if (a.vec) {
        v = *reinterpret_cast<const int4*>(p + chunk * 16);
      } else {
        int words[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int c = chunk * 16 + e;
          if (c < a.C)
            words[e >> 2] |= (int)(uint8_t)p[c * a.sc] << (8 * (e & 3));
        }
        v = make_int4(words[0], words[1], words[2], words[3]);
      }
    }
    tile[u] = v;
  }

  // 2. this thread's (image, pixel, chunk) and its weights
  int r = threadIdx.x;
  const int ch = r % a.cpb;
  r /= a.cpb;
  const int px = r % a.tw;
  r /= a.tw;
  const int py = r % a.th;
  const int img = r / a.th;
  const int n = n0 + img, oy = y0 + py, ox = x0 + px, chunk = k0 + ch;
  const bool live = n < a.B && oy < a.H && ox < a.W && chunk < nchunks;
  int4 wreg[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wreg[t] = live ? *reinterpret_cast<const int4*>(a.w + t * a.cp +
                                                    chunk * 16)
                   : make_int4(0, 0, 0, 0);
  __syncthreads();
  if (!live) return;

  int acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0;
  const int4* base = tile + ((img * TH + py) * TW + px) * a.cpb + ch;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      mac16(acc, base[(i * TW + j) * a.cpb], wreg[i * K + j]);
  }

  // 3. the epilogue: K3's arithmetic, channel by channel
  const int c0 = chunk * 16;
  float y[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const bool in = c0 + e < a.C;
    y[e] = requant::requant_y(acc[e], in ? a.scale[c0 + e] : 0.0f,
                              in ? a.bias[c0 + e] : 0.0f, a.relu);
  }
  const long long pix = ((long long)n * a.H + oy) * a.W + ox;
  if (a.q != nullptr) {
    const float sy = *a.s_y;
    int words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      words[e >> 2] |= (int)(uint8_t)requant::requant_q(y[e], sy)
                       << (8 * (e & 3));
    // the whole chunk: q's pixel pitch is a multiple of 16
    *reinterpret_cast<int4*>(a.q + pix * a.ldq + c0) =
        make_int4(words[0], words[1], words[2], words[3]);
  }
  if (a.f_kind == 1) {
    float* fp = static_cast<float*>(a.f) + pix * a.C + c0;
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      if (a.f_vec == 4) {
        if (c0 + e < a.C)
          *reinterpret_cast<float4*>(fp + e) =
              make_float4(y[e], y[e + 1], y[e + 2], y[e + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c0 + e + i < a.C) fp[e + i] = y[e + i];
      }
    }
  } else if (a.f_kind == 2) {
    __nv_bfloat16* fp = static_cast<__nv_bfloat16*>(a.f) + pix * a.C + c0;
#pragma unroll
    for (int e = 0; e < 16; e += 8) {
      if (a.f_vec == 8) {
        if (c0 + e < a.C) {
          unsigned v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = (unsigned)__bfloat16_as_ushort(
                       __float2bfloat16_rn(y[e + 2 * i])) |
                   (unsigned)__bfloat16_as_ushort(
                       __float2bfloat16_rn(y[e + 2 * i + 1])) << 16;
          *reinterpret_cast<int4*>(fp + e) =
              make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (c0 + e + i < a.C) fp[e + i] = __float2bfloat16_rn(y[e + i]);
      }
    }
  }
}

template <int K>
int launch(const Args& a, long long blocks, int threads, int smem,
           cudaStream_t stream) {
  // set on every launch: the limit belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      dw_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();                      // clear it; the caller raises
    return (int)e;
  }
  dw_kernel<K><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the NHWC int8 activation (B, H, W, C) with byte strides sn, sy, sx,
// sc; vec = 1 when x and sn, sy, sx are 16-byte multiples, sc = 1 and
// sx >= C, so that 16-byte loads stay inside each pixel's pitch. w: the
// (k * k, cp) int8 weights, cp = C rounded up to 16, 16-byte aligned, zero
// past C (pack_dw_weight). scale, bias: (C,) float32. s_y: one float32 in
// device memory, read only when q is given. q: (B, H, W) pixels of ldq
// bytes (a multiple of 16, >= cp), or null. f: (B, H, W, C) float32
// (f_kind 1) or bfloat16 (2), or null (0), stored f_vec elements at a time
// (4 or 8 where C allows, else 1). Launches on `stream` and returns the
// first CUDA error (0 on success), a refused launch included; a k other
// than 1, 3 or 5 is cudaErrorInvalidValue.
extern "C" int dw_launch(const void* x, long long sn, long long sy,
                         long long sx, long long sc, int vec, int B, int H,
                         int W, int C, int k, const void* w,
                         const float* scale, const float* bias,
                         const float* s_y, void* q, long long ldq, void* f,
                         int f_kind, int f_vec, int relu, void* stream) {
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.sn = sn;
  a.sy = sy;
  a.sx = sx;
  a.sc = sc;
  a.vec = vec;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.cp = (C + 15) / 16 * 16;
  a.ph = (k - 1) / 2;
  a.pw = (k - 1) / 2;
  a.w = static_cast<const int8_t*>(w);
  a.scale = scale;
  a.bias = bias;
  a.s_y = s_y;
  a.q = static_cast<int8_t*>(q);
  a.ldq = ldq;
  a.f = f;
  a.f_kind = f_kind;
  a.f_vec = f_vec;
  a.relu = relu;
  if (B < 1 || H < 1 || W < 1 || C < 1 || (q == nullptr && f_kind == 0) ||
      (f_kind != 0 && f_vec != 1 && f_vec != 4 && f_vec != 8))
    return (int)cudaErrorInvalidValue;

  // the tile: up to 8 x 8 pixels, then chunks (a divisor of their count),
  // then images, up to kMaxThreads threads
  const int nchunks = a.cp / 16;
  a.th = H < kTile ? H : kTile;
  a.tw = W < kTile ? W : kTile;
  const int pixels = a.th * a.tw;
  const int cap = kMaxThreads / pixels;
  a.cpb = 1;
  for (int d = 1; d <= nchunks && d <= cap; ++d)
    if (nchunks % d == 0) a.cpb = d;
  a.ipb = kMaxThreads / (pixels * a.cpb);
  if (a.ipb > B) a.ipb = B;
  if (a.ipb < 1) a.ipb = 1;
  a.tiles_y = (H + a.th - 1) / a.th;
  a.tiles_x = (W + a.tw - 1) / a.tw;
  a.groups = nchunks / a.cpb;
  const int threads = a.ipb * pixels * a.cpb;
  const long long blocks = (long long)((B + a.ipb - 1) / a.ipb) * a.tiles_y *
                           a.tiles_x * a.groups;
  const int smem =
      a.ipb * (a.th + k - 1) * (a.tw + k - 1) * a.cpb * (int)sizeof(int4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(a, blocks, threads, smem, s);
    case 3: return launch<3>(a, blocks, threads, smem, s);
    case 5: return launch<5>(a, blocks, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
