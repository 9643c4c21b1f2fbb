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
// epilogue is K3's arithmetic (requant.cuh), q by its exact reciprocal rule.
//
// Bound: bytes (every input byte read once, every output written once: 1
// byte for q, 2 or 4 for f). At the card's byte rate an output may take
// only about 18 instruction issues of its SM; this kernel's first form (a
// dp4a of the input word against the tap masked to one byte, two
// instructions a channel and tap; an IEEE division an output; % and / on
// every staged chunk) took about 40. The design:
//
// - Four taps a dp4a. The staged tile is transposed so that one 32-bit word
//   holds 4 horizontally adjacent pixels of one channel. A thread owns 4
//   channels x 2 output rows x 4 adjacent output columns. For a window row
//   it reads two words W0, W1 (columns x0 - pad .. x0 - pad + 7) of each of
//   its channels; the window of output column x0 + t is bytes t .. t + 3 of
//   (W0, W1) (W0, three byte_perms, W1), which one dp4a meets with the
//   channel's taps of that row (w0, w1, w2, 0) for k = 3; k = 5 adds a
//   dp4a of window t + 1 against (0, 0, 0, w4); k = 1 meets W0 with the tap
//   shifted to byte t. Each staged row serves both output rows of the
//   thread: 3 dp4a and 1.5 byte_perms an output at k = 3.
// - Staging without instructions: the tensor memory accelerator copies a
//   tile with its halo (cb channels x (tw + 4) pixels x (th + k - 1) rows
//   x ipb images, zeros outside the tensor: the SAME padding) into a ring
//   of three slots, two tiles ahead of the one being computed; one thread
//   issues each copy and a barrier a slot reports it. The block transposes
//   the landed tile once (8 byte_perms per 4 x 4 bytes) into [channel]
//   words, so that a thread reads its 4 channels' word with one 16-byte
//   load. The taps are repacked once a block, a channel's window row a
//   word, so pack_dw_weight's (k * k, Cp) operand stays. Inputs the tensor
//   map cannot describe (pixels not 16-byte aligned) are staged a byte at
//   a time into the same slots.
// - Persistent blocks: a block keeps its (tile, channel group) and walks
//   the image groups, as many blocks as the card holds at once.
// - The epilogue: the accumulators start at 1.5 * 2^23, so float(acc) is a
//   subtract of the same constant (exact: |acc| < 2^22) instead of an int to
//   float conversion; q is requant.cuh's reciprocal rule, a multiply and a
//   rint by an add, bit-identical to the division, which is taken only for
//   y / s_y within 2^-15 of a half-integer; with q alone a ReLU folds into
//   the rule's clamp, a saturating multiply. A thread stores its 4 channels of a pixel together: 4
//   bytes of q, 8 of bfloat16 f, 16 of float32 f; a bfloat16 f of a C that
//   is not a multiple of 4 goes through shared memory, a pixel's run of
//   channels a thread.
// - No division in the index math: the kernel is templated on k and the
//   tile (th x tw output pixels); the channels a block (cb = 16, 32, 64)
//   and the images a tile (ipb) are powers of two and decoded by shifts.
//   The host (ops/int8_dwconv.py::plan_launch) picks the tile, cb and ipb
//   so that small maps take many images a tile and every call that has the
//   work still has a tile for each of the 132 SMs.
// - The bytes between C and the pitch of a 16-byte aligned activation hold
//   anything: they meet zero weights (pack_dw_weight) and their q is
//   stored as the pitch (f is never stored past C).
//
// Numerics: build with --fmad=false, without -ftz and without
// --use_fast_math: the int32 sums are exact (|acc| <= k^2 * 128^2), q is
// bit-identical to the plain version and f equal to it.

#include <cuda.h>        // CUtensorMap; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "requant.cuh"

namespace {

constexpr int kMaxThreads = 256;     // the kernel's threads a block, at most
constexpr int kStages = 3;            // tiles staged at once: 2 in flight
constexpr int kAcc0 = 0x4B400000;     // the bits of 1.5 * 2^23

struct Args {
  const int8_t* x;                  // NHWC activation
  long long sn, sy, sx, sc;         // its byte strides
  int tma;                          // staged by the tensor map, else bytes
  int B, H, W, C, cp;               // cp = C rounded up to 16
  const int8_t* w;                  // (k * k, cp) packed weights
  const float* scale;
  const float* bias;
  const float* s_y;
  int8_t* q;                        // (B, H, W) pixels of ldq bytes, or null
  long long ldq;
  void* f;                          // (B, H, W, C), or null
  int f_kind;                       // 0 none, 1 float32, 2 bfloat16
  int f_vec;                        // 4: a thread's 4 channels one store
  int relu;
  int cb_log, ipb_log;              // cb = 16 << cb_log, ipb = 1 << ipb_log
  int tiles_x;
};

// bytes 0..3 of (a, b, c, d) -> word e = byte e of each: a 4 x 4 transpose
__device__ __forceinline__ void transpose4(unsigned a, unsigned b, unsigned c,
                                           unsigned d, unsigned* e) {
  const unsigned t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(c, d, 0x5140);
  const unsigned t2 = __byte_perm(a, b, 0x7362), t3 = __byte_perm(c, d, 0x7362);
  e[0] = __byte_perm(t0, t1, 0x5410);
  e[1] = __byte_perm(t0, t1, 0x7632);
  e[2] = __byte_perm(t2, t3, 0x5410);
  e[3] = __byte_perm(t2, t3, 0x7632);
}

// 16 channels of one pixel, a byte at a time (the scalar path)
__device__ __forceinline__ int4 load_chunk_bytes(const int8_t* p,
                                                 long long sc, int c0, int C) {
  int words[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (c0 + e < C) words[e >> 2] |= (int)(uint8_t)p[(c0 + e) * sc]
                                     << (8 * (e & 3));
  return make_int4(words[0], words[1], words[2], words[3]);
}

__device__ __noinline__ int requant_q_divided(float y, float sy) {
  return requant::requant_q(y, sy);
}

// The q bytes of a pixel's 4 channels as one word: the reciprocal rule
// (RELU: y before its ReLU, folded into the rule; inv > 0), and the
// division for the outputs in its band (on y after any ReLU)
template <bool RELU>
__device__ __forceinline__ int q_word(const float* y, float inv, float band,
                                      float sy, int relu) {
  int qs[4];
  float d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    d[e] = RELU ? requant::requant_q_recip_relu_step(y[e], inv, &qs[e])
                : requant::requant_q_recip_step(y[e], inv, &qs[e]);
  if (!(fabsf(d[0]) <= band && fabsf(d[1]) <= band && fabsf(d[2]) <= band &&
        fabsf(d[3]) <= band)) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!(fabsf(d[e]) <= band))
        qs[e] = requant_q_divided(relu ? fmaxf(y[e], 0.0f) : y[e], sy);
  }
  const unsigned w = __byte_perm(__byte_perm(qs[0], qs[1], 0x0040),
                                 __byte_perm(qs[2], qs[3], 0x0040), 0x5410);
  return (int)(RELU ? requant::relu_bytes(w) : w);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the phase of the given parity of a barrier to complete
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One tile's input with its halo, copied by the tensor memory accelerator:
// the box (cb channels, 4 * NW pixels, THS rows, ipb images) at channel c0,
// pixel x0 - P, row y0 - P, image n0, NHWC bytes, zeros outside the tensor
// (the SAME padding and the images past the batch). One thread issues it;
// `bar` completes when its bytes have landed.
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, unsigned bytes,
                                         int c0, int x, int y, int n) {
  // the block's reads of this slot (generic) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(x), "r"(y), "r"(n),
      "r"(smem_addr(bar))
      : "memory");
}

// The same tile a byte at a time, for inputs the tensor map cannot describe
// (vec = 0: channels apart, or pixels not 16-byte aligned): [img][row]
// [pixel][cb bytes], every thread of the block taking part.
template <int K, int THS, int NW>
__device__ __forceinline__ void byte_tile(const Args& a, int8_t* raw, int n0,
                                          int y0, int x0, int c0) {
  constexpr int P = (K - 1) / 2;
  const int cb = 16 << a.cb_log;
  const int n16 = (THS * 4 * NW << a.ipb_log) << a.cb_log;
  for (int u = threadIdx.x; u < n16; u += blockDim.x) {
    const int c16 = u & ((1 << a.cb_log) - 1), pix = u >> a.cb_log;
    const int px = pix % (4 * NW), rf = pix / (4 * NW);
    const int img = rf / THS, row = rf - img * THS;
    const int n = n0 + img, yy = y0 - P + row, xx = x0 - P + px;
    int4 v = make_int4(0, 0, 0, 0);
    if (n < a.B && (unsigned)yy < (unsigned)a.H &&
        (unsigned)xx < (unsigned)a.W)
      v = load_chunk_bytes(a.x + n * a.sn + yy * a.sy + xx * a.sx, a.sc,
                           c0 + c16 * 16, a.C);
    *reinterpret_cast<int4*>(raw + pix * cb + c16 * 16) = v;
  }
}

// Bytes of dw_kernel's shared memory for a th x tw tile of cb channels and
// ipb images and a k x k window, as it lays them out (128 for aligning the
// ring). ops/int8_dwconv.py::plan_launch sizes its plans by the same count;
// dw_launch refuses a plan that gives a block less.
constexpr long long smem_bytes(int th, int tw, int cb, int ipb, int k) {
  const long long groups =
      (long long)(th + k - 1) * (tw / 4 + (k > 1 ? 1 : 0)) * ipb;
  return 128 + kStages * ((groups * 4 * cb + 127) / 128 * 128) +
         4 * groups * (cb + 4) + 4LL * (k * (k == 5 ? 2 : 1) * cb + 2 * cb) +
         8 * kStages;
}

// y of one output from its biased sum (1.5 * 2^23 + sum: the subtract is
// exact, |sum| < 2^22), K3's operations
__device__ __forceinline__ float y_of(int acc, float scale, float bias) {
  const float s = __fsub_rn(__int_as_float(acc), requant::kRound);
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

template <int K, int TH, int TW>
__global__ void __launch_bounds__(kMaxThreads, K == 5 ? 2 : 3)
    dw_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  constexpr int THS = TH + K - 1;               // staged rows
  constexpr int NW = TW / 4 + (K > 1 ? 1 : 0);  // staged words a row
  constexpr int NWK = K == 5 ? 2 : 1;           // tap words a window row
  constexpr int JB = TW == 32 ? 3 : TW == 16 ? 2 : TW == 8 ? 1 : 0;
  constexpr int RB = TH == 8 ? 2 : TH == 4 ? 1 : 0;
  static_assert((4 << JB) == TW && (2 << RB) == TH, "tile");

  const int cb = 16 << a.cb_log;                // channels of the block
  const int cgb = a.cb_log + 2;                 // log2(cb / 4)
  const int xw = cb + 4;        // words of a (row, word) group: 4 spare
  const int groups_a_tile = THS * NW << a.ipb_log;
  // the staged tiles (a ring of kStages, each [ipb][THS][4 * NW][cb] bytes,
  // 128-byte aligned for the tensor copies), the tile transposed to words
  // ([ipb][THS][NW][xw]), the taps ([K][NWK][cb]), scales and biases ([cb]
  // each) and the ring's barriers: smem_bytes counts them
  extern __shared__ int4 smem4[];
  const unsigned tile_bytes = (unsigned)(groups_a_tile * 4 * cb);
  const int ring_pitch = (tile_bytes + 127) & ~127;
  int8_t* ring = reinterpret_cast<int8_t*>(smem4) +
                 ((128u - (smem_addr(smem4) & 127u)) & 127u);
  int* xs = reinterpret_cast<int*>(ring + kStages * ring_pitch);
  int* ws = xs + groups_a_tile * xw;
  float* ss = reinterpret_cast<float*>(ws + K * NWK * cb);
  float* bs = ss + cb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bs + cb);

  const int tx = (int)(blockIdx.x % (unsigned)a.tiles_x);
  const int ty = (int)(blockIdx.x / (unsigned)a.tiles_x);
  const int x0 = tx * TW, y0 = ty * TH;
  const int c0 = (int)blockIdx.y * cb;          // first channel
  const int groups = (a.B + (1 << a.ipb_log) - 1) >> a.ipb_log;
  const int tid = threadIdx.x;

  constexpr int P = (K - 1) / 2;
  int bz = blockIdx.z;
  // tile z of this block's column into ring slot `slot`
  auto stage = [&](int slot, int z) {
    int8_t* dst = ring + slot * ring_pitch;
    if (a.tma) {
      if (tid == 0)
        tma_tile(&map, dst, &bars[slot], tile_bytes, c0, x0 - P, y0 - P,
                 z << a.ipb_log);
    } else {
      byte_tile<K, THS, NW>(a, dst, z << a.ipb_log, y0, x0, c0);
    }
  };
  if (a.tma && tid == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first tiles' copies go out before anything else
  for (int i = 0; i < kStages - 1; ++i)
    if (bz + i * (int)gridDim.z < groups) stage(i, bz + i * gridDim.z);

  // the taps, a channel's window row a word: (w0, w1, w2, 0) for k = 3,
  // (w0, w1, w2, w3) and (0, 0, 0, w4) for k = 5, (w0, 0, 0, 0) for k = 1
  for (int u = tid; u < K * cb; u += blockDim.x) {
    const int c = u & (cb - 1), kh = u >> (a.cb_log + 4);
    const int8_t* wp = a.w + kh * K * a.cp + c0 + c;
    unsigned w0 = 0;
#pragma unroll
    for (int kw = 0; kw < (K < 4 ? K : 4); ++kw)
      w0 |= (unsigned)(uint8_t)wp[kw * a.cp] << (8 * kw);
    ws[kh * NWK * cb + c] = (int)w0;
    if constexpr (K == 5)
      ws[(kh * NWK + 1) * cb + c] = (int)(uint8_t)wp[4 * a.cp] << 24;
  }
  for (int u = tid; u < cb; u += blockDim.x) {
    const bool in = c0 + u < a.C;
    ss[u] = in ? a.scale[c0 + u] : 0.0f;
    bs[u] = in ? a.bias[c0 + u] : 0.0f;
  }

  // this thread's 4 channels x 2 rows x 4 columns of each tile, and which
  // of its 8 pixels lie inside the map
  const int cg = tid & ((1 << cgb) - 1);
  const int jg = (tid >> cgb) & ((1 << JB) - 1);
  const int rg = (tid >> (cgb + JB)) & ((1 << RB) - 1);
  const int img = tid >> (cgb + JB + RB);
  const int ch = c0 + 4 * cg;                   // the thread's first channel
  const int oy0 = y0 + 2 * rg, ox0 = x0 + 4 * jg;
  unsigned inside = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (oy0 + r < a.H && ox0 + t < a.W) inside |= 1u << (4 * r + t);
  // q: the reciprocal rule; with q alone a ReLU folds into it
  float sy = 0.0f, inv = 0.0f, band = -1.0f;
  if (a.q != nullptr) {
    sy = *a.s_y;
    band = requant::recip_band(sy, &inv);
  }
  const bool q_alone = a.q != nullptr && a.f_kind == 0 && a.relu && inv > 0;
  __syncthreads();                              // the taps, scales, biases

  // the block's image groups, one tile after another: the next
  // kStages - 1 tiles' copies are in flight while this one is computed
  for (int it = 0; bz < groups; bz += gridDim.z, ++it) {
    const int slot = it % kStages;
    const int ahead = bz + (kStages - 1) * gridDim.z;
    if (ahead < groups) stage((it + kStages - 1) % kStages, ahead);
    if (a.tma) bar_wait(&bars[slot], (it / kStages) & 1);
    __syncthreads();            // the tile has landed; xs is free again

    // 1. the tile transposed to [channel] words of 4 adjacent pixels
    const int8_t* raw = ring + slot * ring_pitch;
    for (int u = tid; u < groups_a_tile << a.cb_log; u += blockDim.x) {
      const int c16 = u & ((1 << a.cb_log) - 1), g = u >> a.cb_log;
      const int4* src =
          reinterpret_cast<const int4*>(raw + g * 4 * cb + c16 * 16);
      const int4 p0 = src[0], p1 = src[cb / 16], p2 = src[cb / 8],
                 p3 = src[3 * cb / 16];
      int4* dst = reinterpret_cast<int4*>(xs + g * xw + c16 * 16);
      unsigned e[4];
      transpose4(p0.x, p1.x, p2.x, p3.x, e);
      dst[0] = make_int4(e[0], e[1], e[2], e[3]);
      transpose4(p0.y, p1.y, p2.y, p3.y, e);
      dst[1] = make_int4(e[0], e[1], e[2], e[3]);
      transpose4(p0.z, p1.z, p2.z, p3.z, e);
      dst[2] = make_int4(e[0], e[1], e[2], e[3]);
      transpose4(p0.w, p1.w, p2.w, p3.w, e);
      dst[3] = make_int4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();

    const int n = (bz << a.ipb_log) + img;
    const bool live = n < a.B;

    // 2. the sums: each staged row meets both output rows
    int acc[2][4][4];                           // [row][channel][column]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[r][e][t] = kAcc0;
    const int* base = xs + ((img * THS + 2 * rg) * NW + jg) * xw + 4 * cg;
    if (live) {
    const int* wsc = ws + 4 * cg;
#pragma unroll
    for (int i = 0; i < K + 1; ++i) {
      const int4 lo4 = *reinterpret_cast<const int4*>(base + i * NW * xw);
      int4 hi4 = lo4;
      if constexpr (K > 1)
        hi4 = *reinterpret_cast<const int4*>(base + i * NW * xw + xw);
      const int w0s[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
      const int w1s[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kh = i - r;
        if (kh < 0 || kh >= K) continue;
        // the taps of window row kh, 4 channels (two words for k = 5)
        const int4 ta = *reinterpret_cast<const int4*>(wsc + kh * NWK * cb);
        int4 tb = ta;
        if constexpr (K == 5)
          tb = *reinterpret_cast<const int4*>(wsc + (kh * NWK + 1) * cb);
        const int tas[4] = {ta.x, ta.y, ta.z, ta.w};
        const int tbs[4] = {tb.x, tb.y, tb.z, tb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned W0 = (unsigned)w0s[e], W1 = (unsigned)w1s[e];
          const int win[5] = {(int)W0, (int)__byte_perm(W0, W1, 0x4321),
                              (int)__byte_perm(W0, W1, 0x5432),
                              (int)__byte_perm(W0, W1, 0x6543), (int)W1};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if constexpr (K == 1) {
              acc[r][e][t] = __dp4a(win[0], tas[e] << (8 * t), acc[r][e][t]);
            } else {
              acc[r][e][t] = __dp4a(win[t], tas[e], acc[r][e][t]);
              if constexpr (K == 5)
                acc[r][e][t] = __dp4a(win[t + 1], tbs[e], acc[r][e][t]);
            }
          }
        }
      }
    }

    }

    // 3. the epilogue, a pixel's 4 channels at a time. The calibrated
    // net's case, q alone after a ReLU folded into the requantisation, has
    // a path of its own. A bfloat16 f whose C is not a multiple of 4 goes
    // through shared memory (the transposed tile's, now read), an output
    // row of the thread at a time, so that the block stores each pixel's
    // channels as one run
    const float4 sc4 = *reinterpret_cast<const float4*>(ss + 4 * cg);
    const float4 bi4 = *reinterpret_cast<const float4*>(bs + 4 * cg);
    const float scs[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const float bis[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
    const bool f_staged = a.f_kind == 2 && a.f_vec != 4;
    __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(xs);
    auto pixels = [&](auto q_alone_tag) {
      constexpr bool QA = decltype(q_alone_tag)::value;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!QA && f_staged) __syncthreads();   // xs is read
        const long long pix0 = ((long long)n * a.H + oy0 + r) * a.W + ox0;
        int8_t* qp = a.q + pix0 * a.ldq + ch;
#pragma unroll
        for (int t = 0; t < 4; ++t, qp += a.ldq) {
          if (!live || !(inside >> (4 * r + t) & 1)) continue;
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = y_of(acc[r][e][t], scs[e], bis[e]);
            if (!QA && a.relu) y[e] = fmaxf(y[e], 0.0f);
          }
          if (QA || a.q != nullptr)
            *reinterpret_cast<int*>(qp) =
                q_word<QA>(y, inv, band, sy, a.relu);
          if (QA) continue;
          const long long pix = pix0 + t;
          if (a.f_kind == 1) {
            float* fp = static_cast<float*>(a.f) + pix * a.C + ch;
            if (a.f_vec == 4) {
              if (ch < a.C)
                *reinterpret_cast<float4*>(fp) =
                    make_float4(y[0], y[1], y[2], y[3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (ch + e < a.C) fp[e] = y[e];
            }
          } else if (a.f_kind == 2) {
            const __nv_bfloat162 lo2 = __floats2bfloat162_rn(y[0], y[1]);
            const __nv_bfloat162 hi2 = __floats2bfloat162_rn(y[2], y[3]);
            uint2 v;
            v.x = *reinterpret_cast<const unsigned*>(&lo2);
            v.y = *reinterpret_cast<const unsigned*>(&hi2);
            if (f_staged) {   // fs[img][rg][pixel of the row][cb]
              *reinterpret_cast<uint2*>(
                  fs + (((img * (TH / 2) + rg) * TW + 4 * jg + t)
                        << (cgb + 2)) + 4 * cg) = v;
            } else if (ch < a.C) {
              *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.f) +
                                        pix * a.C + ch) = v;
            }
          }
        }
        if (!QA && f_staged) {
          __syncthreads();
          // the row's pixels, a channel a thread: consecutive threads on
          // consecutive channels of a pixel
          const int lb = cgb + 2, lw = lb + JB + 2;   // log2 cb, cb * TW
          const int total = (TH / 2 * TW << a.ipb_log) << lb;
          for (int u = tid; u < total; u += blockDim.x) {
            const int c = u & ((1 << lb) - 1);
            const int px = (u >> lb) & (TW - 1);
            const int rr = (u >> lw) & (TH / 2 - 1);
            const int nn = (bz << a.ipb_log) + (u >> (lw + RB));
            const int oy = y0 + 2 * rr + r, ox = x0 + px;
            if (nn < a.B && oy < a.H && ox < a.W && c0 + c < a.C)
              static_cast<__nv_bfloat16*>(
                  a.f)[(((long long)nn * a.H + oy) * a.W + ox) * a.C + c0 +
                       c] = fs[u];
          }
        }
      }
    };
    if (q_alone)
      pixels(std::true_type());
    else
      pixels(std::false_type());
  }
}

// Blocks of one kernel that the current device holds at once (the blocks
// an SM holds at this block size and shared memory, times its SMs), asked
// of the runtime once for each (device, kernel, threads, smem); the first
// ask also lets the kernel have as much shared memory as a block may.
int resident_blocks(const void* fn, int threads, int smem) {
  struct Entry {
    int dev;
    const void* fn;
    int threads, smem, blocks;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.fn == fn && e.threads == threads && e.smem == smem)
      return e.blocks;
  }
  int per_sm = 0, sms = 0, most = 0;
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaGetLastError();           // a failure here shows in the launch
  const int blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (used < 64) cache[used++] = {dev, fn, threads, smem, blocks};
  return blocks;
}

// Persistent blocks: as many (tile, channel group) columns of image groups
// as the grid has, and in z as many blocks as the device then holds at
// once (at most one an image group); each block walks its column's image
// groups with a stride of gridDim.z.
template <int K, int TH, int TW>
int launch(const CUtensorMap& map, const Args& a, dim3 grid, int threads,
           int smem, cudaStream_t stream) {
  const long long columns = (long long)grid.x * grid.y;
  const long long fit =
      resident_blocks((const void*)dw_kernel<K, TH, TW>, threads, smem) /
      columns;
  if (fit < grid.z) grid.z = (unsigned)(fit > 1 ? fit : 1);
  dw_kernel<K, TH, TW><<<grid, threads, smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

template <int K>
int launch_tile(const CUtensorMap& m, const Args& a, int th, int tw,
                dim3 g, int threads, int smem, cudaStream_t s) {
  if (th == 8 && tw == 32) return launch<K, 8, 32>(m, a, g, threads, smem, s);
  if (th == 8 && tw == 16) return launch<K, 8, 16>(m, a, g, threads, smem, s);
  if (th == 8 && tw == 8) return launch<K, 8, 8>(m, a, g, threads, smem, s);
  if (th == 4 && tw == 4) return launch<K, 4, 4>(m, a, g, threads, smem, s);
  if (th == 2 && tw == 4) return launch<K, 2, 4>(m, a, g, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against the driver library); null where the driver lacks it
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
    cudaGetLastError();
  });
  return fn;
}

// The tensor map of x as [B][H][W][cp] bytes and a box of one tile (cb
// channels, tw + k - 1 pixels rounded up to words, th + k - 1 rows, ipb
// images); false where the driver lacks the encoder or refuses x's layout.
bool tile_map(CUtensorMap* map, const Args& a, int th, int tw, int k) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.cp, (cuuint64_t)a.W,
                              (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.sx, (cuuint64_t)a.sy,
                                 (cuuint64_t)a.sn};
  const cuuint32_t box[4] = {16u << a.cb_log,
                             (cuuint32_t)(tw + (k > 1 ? 4 : 0)),
                             (cuuint32_t)(th + k - 1), 1u << a.ipb_log};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, (void*)a.x, dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: the NHWC int8 activation (B, H, W, C) with byte strides sn, sy, sx,
// sc; vec = 1 when x and sn, sy, sx are 16-byte multiples, sc = 1 and
// sx >= C, so that 16-byte chunks stay inside each pixel's pitch: the
// tensor memory accelerator then stages it (and a tensor map the driver
// refuses is cudaErrorNotSupported), else it is staged a byte at a time. w: the
// (k * k, cp) int8 weights, cp = C rounded up to 16, 16-byte aligned, zero
// past C (pack_dw_weight). scale, bias: (C,) float32. s_y: one float32 in
// device memory, read only when q is given. q: (B, H, W) pixels of ldq
// bytes (a multiple of 16, >= cp), or null. f: (B, H, W, C) float32
// (f_kind 1) or bfloat16 (2), or null (0), a thread's 4 channels stored
// together where f_vec is 4 (C a multiple of 4), one at a time where it is
// 1. The plan (ops/int8_dwconv.py::plan_launch), taken as it is: a tile of
// th x tw output pixels, one of 8 x 32, 8 x 16, 8 x 8, 4 x 4, 2 x 4; cb =
// 16 << cb_log channels (cb_log 0..2, cb dividing cp) and 1 << ipb_log
// images a tile; tiles_x x tiles_y tiles of the map; `threads` (a thread
// for each 2 rows x 4 columns x 4 channels of the tile) and `smem` bytes
// (at least smem_bytes) a block; a block walks the tiles of its image
// groups (see launch). Launches on `stream` and returns the first CUDA error (0 on
// success), a refused launch included; a k other than 1, 3 or 5 or a
// plan outside the above is cudaErrorInvalidValue.
extern "C" int dw_launch(const void* x, long long sn, long long sy,
                         long long sx, long long sc, int vec, int B, int H,
                         int W, int C, int k, const void* w,
                         const float* scale, const float* bias,
                         const float* s_y, void* q, long long ldq, void* f,
                         int f_kind, int f_vec, int relu, int th, int tw,
                         int cb_log, int ipb_log, int tiles_x, int tiles_y,
                         int threads, int smem, void* stream) {
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.sn = sn;
  a.sy = sy;
  a.sx = sx;
  a.sc = sc;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.cp = (C + 15) / 16 * 16;
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
  a.cb_log = cb_log;
  a.ipb_log = ipb_log;
  const int cb = 16 << (cb_log & 3);
  if (B < 1 || H < 1 || W < 1 || C < 1 || (q == nullptr && f_kind == 0) ||
      (f_kind != 0 && f_vec != 1 && !(f_vec == 4 && C % 4 == 0)) ||
      cb_log < 0 || cb_log > 2 || a.cp % cb != 0 || ipb_log < 0 ||
      ipb_log > 8 || tiles_x < 1 || tiles_y < 1 ||
      (k != 1 && k != 3 && k != 5) ||
      threads != ((th / 2) * (tw / 4) * (cb / 4) << ipb_log) ||
      smem < smem_bytes(th, tw, cb, 1 << ipb_log, k))
    return (int)cudaErrorInvalidValue;
  a.tiles_x = tiles_x;
  const long long gx = (long long)tiles_x * tiles_y;
  const long long gz = ((long long)B + (1 << ipb_log) - 1) >> ipb_log;
  if (gx > 0x7fffffffLL || gz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)(a.cp / cb), (unsigned)gz);
  alignas(64) CUtensorMap map = {};
  a.tma = vec;
  if (vec && !tile_map(&map, a, th, tw, k))
    return (int)cudaErrorNotSupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_tile<1>(map, a, th, tw, grid, threads, smem, s);
    case 3: return launch_tile<3>(map, a, th, tw, grid, threads, smem, s);
    default: return launch_tile<5>(map, a, th, tw, grid, threads, smem, s);
  }
}
