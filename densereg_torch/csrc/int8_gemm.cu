// int8 GEMM with the requantisation epilogue fused:
//
//   acc = x_q @ w_q                                  (int32)
//   y   = relu?(float(acc) * scale[n] + bias[n])     (float32)
//   q   = clamp(rint(y / s_y), -127, 127)            (int8)  and/or
//   f   = y                                          (float32 or bfloat16)
//
// Replaces the TPU kernel densereg_tpu/ops/int8_gemm.py::int8_gemm_requant
// (Pallas `_kernel`). Semantics oracle:
// densereg_torch.ops.int8_gemm.int8_gemm_requant_reference. In the int8
// serving path every convolution is one call: a 1x1 convolution reads the
// NHWC activation as the (M, K) matrix, a k x k one an int8 im2col of it.
//
// Bound. The card balances 1,979 int8 TOP/s against 3.35 TB/s, about 590
// operations a byte. A call does 2*M*N*K operations on M*K + K*N bytes in
// and M*N (q) or more (f) out, about 2*K*N/(K + N) operations a byte of x
// and q at large M: 512 for the 512-wide 1x1 convolutions of the um head,
// less for every narrower one. So at the serving shapes the bytes bound it,
// and the tiles should stream x and q once.
//
// Design: simple and right first. One block of 4 warps computes a 128 x 64
// tile of the output; it walks K in steps of 64 bytes, staging the x tile
// (128 x 64) and the w tile (64 x 64) in shared memory, and each warp runs
// mma.sync m16n8k32 (s8 x s8 -> s32) on its 32 x 64 share, 16 products per
// 32 of K. No TMA, no wgmma, no pipelining: a later kernel PR replaces this
// main loop. Shared-memory rows are 80 bytes, so the 32-bit fragment loads
// of a warp fall into 32 distinct banks.
//
// Any M, N and K: rows and columns beyond M or N read as zero and are not
// written; K is cut at its end, byte by byte. An operand whose rows start
// at 16-byte multiples is loaded 16 bytes a thread, any other one byte at a
// time. w comes in as its (N, K) transpose, K contiguous, so that the B
// fragments (4 consecutive k at one n) are single 32-bit loads.
//
// Numerics: build with --fmad=false and without --use_fast_math. The
// epilogue is a multiply then an add, each rounded (no FMA), an IEEE
// division by s_y (not a multiply by its reciprocal) and rintf, which
// rounds half to even like jnp.round and torch.round; s_y is read from
// device memory, so the caller never synchronises with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // output rows per block
constexpr int kBN = 64;             // output columns per block
constexpr int kBK = 64;             // bytes of K per step
constexpr int kPitch = kBK + 16;    // shared-memory row, bytes
constexpr int kThreads = 128;       // 4 warps, each 32 rows x 64 columns

// rows x kBK bytes of a row-major int8 operand into shared memory, rows
// [row0, row0 + rows) and columns [k0, k0 + kBK); zero outside nrows x K
__device__ __forceinline__ void load_tile(int8_t* sm, const int8_t* g,
                                          long long ld, bool vec, int rows,
                                          int row0, int nrows, int k0, int K) {
  for (int c = threadIdx.x; c < rows * (kBK / 16); c += kThreads) {
    const int r = c / (kBK / 16);
    const int s = (c % (kBK / 16)) * 16;
    const int gr = row0 + r;
    const int k = k0 + s;
    int4 v = make_int4(0, 0, 0, 0);
    if (gr < nrows && k < K) {
      const int8_t* p = g + (long long)gr * ld + k;
      if (vec && k + 16 <= K) {
        v = *reinterpret_cast<const int4*>(p);
      } else {
        int w[4] = {0, 0, 0, 0};
        for (int j = 0; j < 16; ++j)
          if (k + j < K) w[j >> 2] |= (int)(uint8_t)p[j] << ((j & 3) * 8);
        v = make_int4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<int4*>(sm + r * kPitch + s) = v;
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, long long lda, bool vec_a,
                 const int8_t* __restrict__ B, long long ldb, bool vec_b,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ s_y, int8_t* __restrict__ q,
                 long long ldq, void* __restrict__ f, long long ldf,
                 int f_kind, int M, int N, int K, int relu) {
  __shared__ __align__(16) int8_t As[kBM * kPitch];
  __shared__ __align__(16) int8_t Bs[kBN * kPitch];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile(As, A, lda, vec_a, kBM, m0, M, k0, K);
    load_tile(Bs, B, ldb, vec_b, kBN, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // rows g and g + 8, k t*4..t*4+3 and 16 more
        const int8_t* p = As + (warp * 32 + mi * 16 + g) * kPitch + kk + t * 4;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * kPitch);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        // column g, k t*4..t*4+3 and 16 more
        const int8_t* p = Bs + (ni * 8 + g) * kPitch + kk + t * 4;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const float sy = q != nullptr ? *s_y : 1.0f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + warp * 32 + mi * 16 + g + (i >= 2 ? 8 : 0);
        const int col = n0 + ni * 8 + t * 2 + (i & 1);
        if (row >= M || col >= N) continue;
        float y = __fmul_rn(__int2float_rn(acc[mi][ni][i]), scale[col]);
        y = __fadd_rn(y, bias[col]);
        if (relu) y = fmaxf(y, 0.0f);
        if (q != nullptr) {
          const float r = rintf(__fdiv_rn(y, sy));
          q[(long long)row * ldq + col] =
              (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
        }
        if (f_kind == 1)
          static_cast<float*>(f)[(long long)row * ldf + col] = y;
        else if (f_kind == 2)
          static_cast<__nv_bfloat16*>(f)[(long long)row * ldf + col] =
              __float2bfloat16_rn(y);
      }
    }
  }
}

}  // namespace

// a: (M, K) int8, row pitch lda bytes. b: w transposed, (N, K) int8, row
// pitch ldb. scale, bias: (N,) float32. s_y: one float32 in device memory,
// read only when q is given. q: (M, N) int8 with row pitch ldq, or null.
// f: (M, N) with row pitch ldf, float32 (f_kind 1) or bfloat16 (2), or null
// (0). Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int int8_gemm_launch(const void* a, long long lda, const void* b,
                                long long ldb, const float* scale,
                                const float* bias, const float* s_y, void* q,
                                long long ldq, void* f, long long ldf,
                                int f_kind, int M, int N, int K, int relu,
                                void* stream) {
  const bool vec_a = lda % 16 == 0 && (uintptr_t)a % 16 == 0;
  const bool vec_b = ldb % 16 == 0 && (uintptr_t)b % 16 == 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8_gemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(a), lda, vec_a,
      static_cast<const int8_t*>(b), ldb, vec_b, scale, bias, s_y,
      static_cast<int8_t*>(q), ldq, f, ldf, f_kind, M, N, K, relu);
  return (int)cudaGetLastError();
}
