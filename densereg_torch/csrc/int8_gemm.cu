// int8 convolution / GEMM with the requantisation epilogue fused (K3):
//
//   acc = x_q (*) w_q                                (int32)
//   y   = relu?(float(acc) * scale[n] + bias[n])     (float32)
//   q   = clamp(rint(y / s_y), -127, 127)            (int8)  and/or
//   f   = y                                          (float32 or bfloat16)
//
// Replaces the TPU kernel densereg_tpu/ops/int8_gemm.py::int8_gemm_requant
// (Pallas `_kernel`). Semantics oracle: the plain versions in
// densereg_torch.ops.int8_gemm. Every int8 convolution of the serving net is
// one launch: a k x k one is an implicit GEMM that reads the NHWC activation
// in place (no im2col), a 1x1 stride-1 one (the "dense" entry) reads the
// activation as an (M, K) matrix. Both are the same kernel: a matrix is an
// image of one row of M pixels, convolved 1x1.
//
// Bound. The card balances 1,979 int8 TOP/s against 3.35 TB/s, about 590
// operations a byte. At the serving shapes a 1x1 call does 2KN/(K+N) < 512
// operations a byte of x and q: bytes bound it. A 3x3 call reads each
// activation byte once from device memory but uses it 9 times, so the
// 256-wide 3x3 calls become operation-bound. The design streams x and q
// once and overlaps the loads with the tensor cores:
//
// - Tiles. Two warpgroups compute a 128 x 128 output tile (128 x 64 for
//   N <= 64), each 64 rows with wgmma m64nNk32 (s8 x s8 -> s32, both
//   operands K-major in shared memory, as x and the packed w are), four a
//   K tile. The tensor cores read the operands from shared memory
//   themselves: an mma.sync version of this kernel, whose ldmatrix traffic
//   (the A tile read by 4 warps, B by 2) was what bound its main loop, was
//   bit-identical and slower.
// - Pipeline. A ring of `stages` (default 3) tiles of 128 bytes of K in
//   dynamic shared memory, filled by 16-byte cp.async (through L1, where
//   the taps of a k x k window find the pixels the previous taps brought
//   in) with commit/wait groups, so the next two tiles load while the
//   tensor cores work on the current one. After its copies land each
//   thread fences them into the async proxy that wgmma reads through; the
//   block syncs, issues the next copies and then its wgmmas. The launch
//   raises the kernel's dynamic shared-memory limit to what it needs (98 KB
//   at 3 stages: two blocks an SM); a refused launch returns its error, and
//   the wrapper raises.
// - Layout. A row of a stage is 128 bytes of K (where the channels allow,
//   a whole line of x), stored in wgmma's 128-byte swizzle: the 16-byte
//   chunk c of row r sits at chunk c ^ (r & 7) of its row, 8 rows to a
//   1,024-byte atom. Eight lanes copy the eight chunks of one row, so a
//   warp reads four whole lines and writes shared memory without a bank
//   conflict; the wgmma descriptors name the swizzle, and a K step of 32
//   bytes moves their start address by 32.
// - Launch order. A 1-D grid with the N tile fastest: the N tiles of one M
//   tile run side by side, so x streams from device memory once per call
//   and its siblings read it from the 50 MB L2.
// - Implicit GEMM. K runs over (tap i, tap j, channel) with the channels of
//   a tap padded to Cp = ceil(C / 16) * 16. Each block maps its output rows
//   to (n, oy, ox) once; a 16-byte K chunk is one cp.async from pixel
//   (n, oy*s + i - ph, ox*s + j - pw), channels [c, c + 16). A chunk
//   outside the image, past K or past M or N is zeroed in shared memory by
//   a plain store: it costs no memory request (zero-filled copies from one
//   placeholder address all hit one line of the L2 and cost more than the
//   real loads of the small-N calls).
//   Chunks never straddle taps, since Cp is the tap stride in K.
// - Pitch bytes. Pixels (and matrix rows) start every 16 bytes; the bytes
//   between C and the pitch are never written by their producers and hold
//   anything. The packed weights hold zeros at every padded channel of
//   every tap, so those bytes add exactly 0 to the int32 sums: the kernel
//   reads whole chunks and never masks channels. (A dense call's w rows are
//   also cut at K by the copy's src-size, so any (K, N) view is safe.)
// - Epilogue. scale and bias of the tile's columns are loaded once into
//   shared memory. Each thread turns its fragments into q (and f) and
//   stages them in shared memory; the block then writes whole rows with
//   16-byte stores (q's row pitch is a multiple of 16; f as wide as its
//   pitch allows), so every store fills whole sectors.
//
// Numerics: build with --fmad=false and without --use_fast_math. The
// epilogue (requant.cuh, shared with the depthwise convolution) is a
// multiply then an add, each rounded (no FMA), an IEEE division by s_y (not
// a multiply by its reciprocal) and rintf, which rounds half to even like
// torch.round; s_y is read from device memory, so the caller never
// synchronises with the host. bfloat16 rounds to nearest even, as
// y.to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int kBM = 128;            // output rows per block
constexpr int kBK = 128;            // bytes of K per pipeline stage
constexpr int kThreads = 256;       // 8 warps
constexpr int kChunks = kBK / 16;   // 16-byte chunks in a row of a stage
constexpr int kBKsPerPass = kThreads / kChunks;

struct Args {
  const int8_t* x;                  // NHWC activation (or (M, K) matrix)
  long long sn, sy, sx;             // its byte strides: image, row, pixel
  int H, W, OH, OW;                 // input and output spatial size
  int cp, k, stride, ph, pw;        // channel pitch in K, window, SAME pads
  int M, N, K;                      // K = k * k * cp, a multiple of 16
  const int8_t* w;                  // (N, K) packed weights, row pitch ldw
  long long ldw;
  int kw;                           // bytes of a w row that hold data
  const float* scale;
  const float* bias;
  const float* s_y;
  int8_t* q;                        // (M, N), row pitch ldq, or null
  long long ldq;
  void* f;                          // (M, N), row pitch ldf, or null
  long long ldf;
  int f_kind;                       // 0 none, 1 float32, 2 bfloat16
  int f_vec;                        // elements of f per store
  int relu;
  int stages;                       // depth of the shared-memory ring
  int ring_bytes;                   // ring (and staging) bytes, 1,024-aligned
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the first `bytes` of them copied and the rest
// zero-filled (0 < bytes <= 16); through L1, where the taps of a k x k
// window find the pixels that the previous taps brought in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups are pending (n above 6 waits for 6: stricter)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// shared-memory matrix descriptor of wgmma for a K-major tile in the
// 128-byte swizzle: rows of 128 bytes whose 16-byte chunk c sits at
// c ^ (row & 7), 8-row atoms of 1,024 bytes one after the other
__device__ __forceinline__ uint64_t desc(const int8_t* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)1 << 16) |                     // lbo: unused here
         ((uint64_t)(1024 >> 4) << 32) |           // sbo: 8-row atoms
         ((uint64_t)1 << 62);                      // 128-byte swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, int32, accumulated) += a (64 x 32) * b (32 x N), s8 x s8
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void copy_bytes(void* dst, const void* src,
                                           int n) {
  switch (n) {
    case 16: *static_cast<int4*>(dst) = *static_cast<const int4*>(src); break;
    case 8: *static_cast<int2*>(dst) = *static_cast<const int2*>(src); break;
    case 4: *static_cast<int*>(dst) = *static_cast<const int*>(src); break;
    default:
      *static_cast<short*>(dst) = *static_cast<const short*>(src); break;
  }
}

// shared memory: the ring (reused by the epilogue's staging tiles), then
// scale and bias of the tile
template <int BN>
__host__ __device__ constexpr int stage_bytes() { return (kBM + BN) * kBK; }
template <int BN>
__host__ __device__ constexpr int q_pitch() { return BN + 16; }      // bytes
template <int BN>
__host__ __device__ constexpr int f_pitch() { return BN + 8; }       // elements

template <int BN>
__global__ void __launch_bounds__(kThreads, 2) k3_kernel(const Args a) {
  const int kRing = a.ring_bytes;
  extern __shared__ __align__(1024) int8_t smem_raw[];
  // the swizzle works on address bits: atoms must start 1,024-aligned
  int8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int8_t* ring = smem;
  float* s_scale = reinterpret_cast<float*>(smem + kRing);
  float* s_bias = s_scale + BN;

  const int ntn = (a.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % ntn) * BN;
  const int m0 = (blockIdx.x / ntn) * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wgi = warp >> 2, wq = warp & 3;  // warpgroup, warp in it

  for (int c = tid; c < BN; c += kThreads) {
    const bool ok = n0 + c < a.N;
    s_scale[c] = ok ? a.scale[n0 + c] : 0.0f;
    s_bias[c] = ok ? a.bias[n0 + c] : 0.0f;
  }

  // this thread's loads: chunk (tid % kChunks) of rows lrow + 32 r
  constexpr int kAPasses = kBM / kBKsPerPass;
  const int cc = (tid % kChunks) * 16;
  const int lrow = tid / kChunks;
  const int8_t* img[kAPasses];
  int iy0[kAPasses], ix0[kAPasses];
  bool rok[kAPasses];
#pragma unroll
  for (int r = 0; r < kAPasses; ++r) {
    const int m = m0 + lrow + kBKsPerPass * r;
    rok[r] = m < a.M;
    const int mm = rok[r] ? m : 0;
    const int per_img = a.OH * a.OW;
    const int n = mm / per_img;
    const int rem = mm - n * per_img;
    const int oy = rem / a.OW;
    const int ox = rem - oy * a.OW;
    img[r] = a.x + n * a.sn;
    iy0[r] = oy * a.stride - a.ph;
    ix0[r] = ox * a.stride - a.pw;
  }

  // byte offset of (row, k) in a 128-byte-swizzled tile
  auto swz = [](int row, int k) {
    return (row >> 3) * 1024 + (row & 7) * 128 + ((((k >> 4) ^ row) & 7) << 4);
  };
  auto load_stage = [&](int slot, int k0) {
    int8_t* As = ring + slot * stage_bytes<BN>();
    int8_t* Bs = As + kBM * kBK;
    const int kc = k0 + cc;
    const bool kin = kc < a.K;
    const int tap = kin ? kc / a.cp : 0;
    const int c = kc - tap * a.cp;
    const int i = tap / a.k;
    const int j = tap - i * a.k;
#pragma unroll
    for (int r = 0; r < kAPasses; ++r) {
      int8_t* dst = As + swz(lrow + kBKsPerPass * r, cc);
      const int iy = iy0[r] + i, ix = ix0[r] + j;
      if (kin && rok[r] && (unsigned)iy < (unsigned)a.H &&
          (unsigned)ix < (unsigned)a.W)
        cp_async16(dst, img[r] + iy * a.sy + ix * a.sx + c, 16);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < BN / kBKsPerPass; ++r) {
      int8_t* dst = Bs + swz(lrow + kBKsPerPass * r, cc);
      const int n = n0 + lrow + kBKsPerPass * r;
      const int bytes = a.kw - kc;           // w's rows end at kw
      if (n < a.N && bytes > 0)
        cp_async16(dst, a.w + n * a.ldw + kc, bytes < 16 ? bytes : 16);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  };

  int acc[BN / 2];                           // wgmma m64nBN: BN / 2 a thread
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;

  const int ktiles = (a.K + kBK - 1) / kBK;
  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kBK);
    cp_async_commit();
  }
  int slot = 0;                              // ring slot of tile kt
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait(a.stages - 2);             // tile kt has landed ...
    fence_async_smem();                      // ... visible to wgmma ...
    __syncthreads();                         // ... for every thread
    const int nxt = kt + a.stages - 1;       // into the slot freed at kt - 1
    if (nxt < ktiles) {
      int ns = slot + a.stages - 1;
      load_stage(ns >= a.stages ? ns - a.stages : ns, nxt * kBK);
    }
    cp_async_commit();
    const int8_t* As = ring + slot * stage_bytes<BN>();
    const int8_t* Bs = As + kBM * kBK;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32)
      wgmma_s8<BN>(acc, desc(As + wgi * 64 * kBK + ks),
                   desc(Bs + ks));
    wg_commit();
    wg_wait0();
    slot = slot + 1 == a.stages ? 0 : slot + 1;
  }
  cp_async_wait(0);
  __syncthreads();                           // the ring is free for staging

  // epilogue: fragments -> q and f tiles in shared memory
  int8_t* sq = ring;
  int8_t* sf = ring + kBM * q_pitch<BN>();
  const bool emit_q = a.q != nullptr;
  const float sy = emit_q ? *a.s_y : 1.0f;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < BN / 8; ++ni) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wgi * 64 + wq * 16 + g + 8 * h;
      const int col = ni * 8 + 2 * t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        y[e] = requant::requant_y(acc[4 * ni + 2 * h + e], s_scale[col + e],
                                  s_bias[col + e], a.relu);
      if (emit_q) {
        uint32_t packed = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          packed |= (uint32_t)(uint8_t)requant::requant_q(y[e], sy)
                    << (8 * e);
        *reinterpret_cast<uint16_t*>(sq + row * q_pitch<BN>() + col) =
            (uint16_t)packed;
      }
      if (a.f_kind == 1) {
        *reinterpret_cast<float2*>(
            reinterpret_cast<float*>(sf) + row * f_pitch<BN>() + col) =
            make_float2(y[0], y[1]);
      } else if (a.f_kind == 2) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(y[0]);
        v.y = __float2bfloat16_rn(y[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<__nv_bfloat16*>(sf) + row * f_pitch<BN>() +
            col) = v;
      }
    }
  }
  __syncthreads();

  // whole rows out: q in 16-byte chunks (its row pitch is a multiple of
  // 16, so a chunk that starts below N stays inside the pitch), f in
  // f_vec elements
  if (emit_q) {
    constexpr int CH = BN / 16;
    for (int u = tid; u < kBM * CH; u += kThreads) {
      const int row = u / CH, col = (u % CH) * 16;
      if (m0 + row < a.M && n0 + col < a.N)
        *reinterpret_cast<int4*>(a.q + (long long)(m0 + row) * a.ldq + n0 +
                                 col) =
            *reinterpret_cast<const int4*>(sq + row * q_pitch<BN>() + col);
    }
  }
  if (a.f_kind != 0) {
    const int esz = a.f_kind == 1 ? 4 : 2;
    const int per_row = BN / a.f_vec;
    for (int u = tid; u < kBM * per_row; u += kThreads) {
      const int row = u / per_row, col = (u % per_row) * a.f_vec;
      if (m0 + row < a.M && n0 + col < a.N)
        copy_bytes(static_cast<char*>(a.f) +
                       ((long long)(m0 + row) * a.ldf + n0 + col) * esz,
                   sf + (row * f_pitch<BN>() + col) * esz, a.f_vec * esz);
    }
  }
}

template <int BN>
int launch(const Args& a, cudaStream_t stream) {
  const int ring = a.stages * stage_bytes<BN>();
  const int staging = kBM * q_pitch<BN>() +
                      kBM * f_pitch<BN>() * (a.f_kind == 1 ? 4 : 2);
  Args b = a;
  b.ring_bytes = ((ring > staging ? ring : staging) + 1023) / 1024 * 1024;
  const int smem = b.ring_bytes + 2 * BN * (int)sizeof(float) + 1024;
  // set on every launch: the limit belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      k3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();                      // clear it; the caller raises
    return (int)e;
  }
  const long long blocks =
      (long long)((a.M + kBM - 1) / kBM) * ((a.N + BN - 1) / BN);
  k3_kernel<BN><<<(unsigned)blocks, kThreads, smem, stream>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the NHWC int8 activation (b, H, W, *) with byte strides sn, sy, sx
// (multiples of 16, as is x), read at channels [0, cp) of each pixel; a
// matrix is passed as b = H = 1, W = M, sx = its row pitch. The window is
// k x k with stride `stride` and SAME pads ph, pw before; the output is
// (b, OH, OW) pixels = M rows. w: (N, k * k * cp) int8, row pitch ldw (a
// multiple of 16), of which the first kw bytes of a row are read. scale,
// bias: (N,) float32. s_y: one float32 in device memory, read only when q
// is given. q: (M, N) int8 with row pitch ldq (a multiple of 16), or null.
// f: (M, N) with row pitch ldf, float32 (f_kind 1) or bfloat16 (2), or null
// (0), stored f_vec elements at a time. Launches on `stream` and returns
// the first CUDA error (0 on success), a refused launch included.
extern "C" int k3_launch(const void* x, long long sn, long long sy,
                         long long sx, int b, int H, int W, int OH, int OW,
                         int cp, int k, int stride, int ph, int pw, int N,
                         const void* w, long long ldw, int kw,
                         const float* scale, const float* bias,
                         const float* s_y, void* q, long long ldq, void* f,
                         long long ldf, int f_kind, int f_vec, int relu,
                         int stages, void* stream) {
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.sn = sn;
  a.sy = sy;
  a.sx = sx;
  a.H = H;
  a.W = W;
  a.OH = OH;
  a.OW = OW;
  a.cp = cp;
  a.k = k;
  a.stride = stride;
  a.ph = ph;
  a.pw = pw;
  a.M = b * OH * OW;
  a.N = N;
  a.K = k * k * cp;
  a.w = static_cast<const int8_t*>(w);
  a.ldw = ldw;
  a.kw = kw;
  a.scale = scale;
  a.bias = bias;
  a.s_y = s_y;
  a.q = static_cast<int8_t*>(q);
  a.ldq = ldq;
  a.f = f;
  a.ldf = ldf;
  a.f_kind = f_kind;
  a.f_vec = f_vec;
  a.relu = relu;
  a.stages = stages;
  if (stages < 2 || (f_kind != 0 && f_vec < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N <= 64 ? launch<64>(a, s) : launch<128>(a, s);
}
