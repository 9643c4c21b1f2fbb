// A standalone int8 quantize step of the calibrated int8 forward, with the
// sum of a residual or an hourglass folded in:
//
//   s = max(amax, 1e-8) / 127                 (float32, one thread writes it)
//   f = a + b                                 (only with b; a's dtype)
//   q = clamp(rint(v / s), -127, 127)         (int8; v = f with b, else a)
//
// a and b are contiguous NHWC of any C >= 1, float32 or bfloat16; amax a
// device float32. q's rows (pixels) start every ceil(C / 16) * 16 bytes, so
// K3 and the depthwise kernel read it in place; the bytes between C and the
// pitch hold anything (they meet zero weights there).
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it (densereg_tpu/models/layers.py, ConvBR.__call__ and
// quantize_output). Eagerly, PyTorch ran it as 7 launches (8 with the sum)
// that each read and wrote the whole tensor. Semantics oracle:
// densereg_torch.ops.int8_quantize.int8_quantize_reference.
//
// Bound: bytes. Each element is read once from each input and written once
// to each output: 5 bytes a float32 element, 13 with the sum. At 3.35 TB/s
// a float32 element without the sum may take about 44 instruction issues of
// its SM. The design:
//
// - One pass. Every thread derives the scale from amax (one cached load),
//   so nothing runs before the kernel, and a launch is the whole step.
// - 16-byte loads: a thread takes 16 bytes of each input (4 float32 or 8
//   bfloat16 elements) and stores 16 bytes of f; a warp's loads cover
//   whole lines, and each thread issues kUnroll of them, with the streaming
//   hint (the inputs are read once), before it uses any.
// - q where C % 16 == 0 (every width of 32..512 of the nets): the pitch is
//   then C, q as flat as a, and a thread stores its 4 or 8 q bytes at once.
//   Other C (the stem's depth of 1, the concatenations' 105, 131, 170 and
//   515) and inputs off 16-byte multiples go one element a thread, each
//   element's row by one integer division; on the lite net these steps
//   hold about a fifth of the bytes, and row tiles staged in shared memory
//   saved only ~0.5 ms of a forward's ~8.5 ms of steps.
// - No division an element for q: requant.cuh's exact reciprocal rule (a
//   multiply and a rint by an add, the division only for a quotient within
//   2^-15 of a tie).
// - The grid: at most kBlocksPerSm blocks an SM, each walking the tensor
//   with the grid's stride, so a small map (2x2, 4x4) is one short launch
//   and a large one keeps every SM's loads in flight.
//
// Numerics: build with --fmad=false, without -ftz and without
// --use_fast_math. q is requant_q of each value (bit-identical to the IEEE
// division and rintf's round half to even, as torch.round), except that a
// NaN quotient gives 0, as torch's clamp keeps a NaN and its conversion to
// int8 makes it 0 (requant_q gives -127). The bfloat16 sum is taken in
// float32 and rounded once to bfloat16, and q quantizes the rounded value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// a step's constants: the scale, its reciprocal and the band of
// requant.cuh's reciprocal rule; ok is false where the scale is not finite
// (every quotient is then NaN or 0, and every q 0)
struct Scale {
  float s, inv, band;
  bool ok;
};

__device__ __forceinline__ Scale scale_of(const float* amax) {
  Scale k;
  const float m = *amax;
  // a NaN amax stays NaN, as torch.clamp_min keeps it
  k.s = __fdiv_rn(m < 1e-8f ? 1e-8f : m, 127.0f);
  k.ok = isfinite(k.s);
  k.band = requant::recip_band(k.s, &k.inv);
  return k;
}

__device__ __noinline__ int divided(float v, float s) {
  return requant::requant_q(v, s);
}

// requant_q(v, s) in the low byte, by the reciprocal rule with the division
// for the few v whose quotient lies near a tie; 0 for a NaN quotient
__device__ __forceinline__ uint32_t q_byte(float v, const Scale& k) {
  if (!k.ok || v != v) return 0u;
  int q;
  const float d = requant::requant_q_recip_step(v, k.inv, &q);
  if (!(fabsf(d) <= k.band)) q = divided(v, k.s);
  return (uint32_t)q & 0xffu;
}

// 16 bytes of float32: 4 values
__device__ __forceinline__ void unpack(const uint4& w, float* v, float) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}

// 16 bytes of bfloat16: 8 values
__device__ __forceinline__ void unpack(const uint4& w, float* v,
                                       __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &u[i], 4);
    const float2 p = __bfloat1622float2(h);
    v[2 * i] = p.x;
    v[2 * i + 1] = p.y;
  }
}

// the sum of a float32 unit, as f's 16 bytes; v becomes the sum
__device__ __forceinline__ uint4 add_pack(float* v, const float* w, float) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], w[i]);
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// the bfloat16 sum: in float32, rounded once; v becomes the rounded sum
__device__ __forceinline__ uint4 add_pack(float* v, const float* w,
                                          __nv_bfloat16) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        __fadd_rn(v[2 * i], w[2 * i]), __fadd_rn(v[2 * i + 1], w[2 * i + 1]));
    const float2 p = __bfloat1622float2(h);
    v[2 * i] = p.x;
    v[2 * i + 1] = p.y;
    memcpy(&u[i], &h, 4);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void store_q(int8_t* q, long long unit,
                                        const uint32_t* b, float) {
  reinterpret_cast<uint32_t*>(q)[unit] =
      b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
}

__device__ __forceinline__ void store_q(int8_t* q, long long unit,
                                        const uint32_t* b, __nv_bfloat16) {
  reinterpret_cast<uint2*>(q)[unit] =
      make_uint2(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
                 b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the sum rounded to T, stored to *out; returns the float value q takes
__device__ __forceinline__ float add_round(float x, float y, float* out) {
  *out = __fadd_rn(x, y);
  return *out;
}
__device__ __forceinline__ float add_round(float x, float y,
                                           __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(__fadd_rn(x, y));
  return __bfloat162float(*out);
}

// element e alone: q at its row's pitch (a 32-bit division where n
// allows: a 64-bit one costs several times more instructions)
template <typename T, bool kSum>
__device__ __forceinline__ void quantize_one(
    const T* __restrict__ a, const T* __restrict__ b, int8_t* __restrict__ q,
    T* __restrict__ f, long long e, int c, int pitch, bool narrow,
    const Scale& k) {
  float v = to_float(__ldcs(a + e));
  if (kSum) v = add_round(v, to_float(__ldcs(b + e)), f + e);
  const long long row =
      narrow ? (long long)((uint32_t)e / (uint32_t)c) : e / c;
  q[row * pitch + (e - row * c)] = (int8_t)q_byte(v, k);
}

// Loads kUnroll units of 16 bytes a thread, at `first + u * kThreads` for
// u < kUnroll (those below `units`), before any is used.
template <bool kSum>
__device__ __forceinline__ void load_units(const uint4* __restrict__ a,
                                           const uint4* __restrict__ b,
                                           long long first, long long units,
                                           uint4* wa, uint4* wb) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = first + (long long)u * kThreads;
    if (i < units) {
      wa[u] = __ldcs(a + i);
      if (kSum) wb[u] = __ldcs(b + i);
    }
  }
}

// A unit's values (the sum, stored to f's unit, with the addend) and their
// q bytes.
template <typename T, bool kSum>
__device__ __forceinline__ void quantize_unit(const uint4& wa,
                                              const uint4& wb,
                                              uint4* __restrict__ f,
                                              long long i, const Scale& k,
                                              uint32_t* bytes) {
  constexpr int kE = 16 / sizeof(T);
  float v[kE];
  unpack(wa, v, T());
  if (kSum) {
    float w[kE];
    unpack(wb, w, T());
    f[i] = add_pack(v, w, T());
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) bytes[e] = q_byte(v[e], k);
}

// C % 16 == 0: the pitch is C, so q is as flat as a; `units` runs of 16
// input bytes, q's 4 or 8 bytes of each stored at once.
template <typename T, bool kSum>
__global__ void __launch_bounds__(kThreads)
    quantize_flat(const uint4* __restrict__ a, const uint4* __restrict__ b,
                  const float* __restrict__ amax, int8_t* __restrict__ q,
                  uint4* __restrict__ f, float* __restrict__ s_out,
                  long long units) {
  constexpr int kE = 16 / sizeof(T);
  const Scale k = scale_of(amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = k.s;
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll +
                        threadIdx.x;
       base < units; base += step) {
    uint4 wa[kUnroll], wb[kUnroll];
    load_units<kSum>(a, b, base, units, wa, wb);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i >= units) break;
      uint32_t bytes[kE];
      quantize_unit<T, kSum>(wa[u], wb[u], f, i, k, bytes);
      store_q(q, i, bytes, T());
    }
  }
}

// C % 16 != 0, or inputs that do not start at 16-byte multiples: element
// by element
template <typename T, bool kSum>
__global__ void __launch_bounds__(kThreads)
    quantize_elements(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ amax, int8_t* __restrict__ q,
                      T* __restrict__ f, float* __restrict__ s_out,
                      long long n, int c, int pitch) {
  const Scale k = scale_of(amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = k.s;
  const bool narrow = n <= 0xffffffffLL;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads)
    quantize_one<T, kSum>(a, b, q, f, e, c, pitch, narrow, k);
}

// blocks a launch takes at most: enough to fill every SM (the SM count is
// read once a device), each walking the tensor with the grid's stride
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

unsigned grid_for(long long pieces) {
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kMaxDevices ? sms[dev].load() : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaGetLastError();         // a failure here shows in the launch
    n = n > 0 ? n : 1;
    if (dev < kMaxDevices) sms[dev].store(n);
  }
  const long long most = (long long)n * kBlocksPerSm;
  return (unsigned)(pieces < 1 ? 1 : pieces < most ? pieces : most);
}

long long ceil_div(long long x, long long y) { return (x + y - 1) / y; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// the launch's path, reported to the caller
enum Path { kFlat = 0, kElements = 1 };

template <typename T, bool kSum>
int launch(const T* a, const T* b, const float* amax, int8_t* q, T* f,
           float* s, long long n, int c, int pitch, int* path,
           cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);
  if (c % 16 == 0 && pitch == c && aligned16(a) && aligned16(q) &&
      (!kSum || (aligned16(b) && aligned16(f)))) {
    const long long n4 = n / kE;
    *path = kFlat;
    quantize_flat<T, kSum>
        <<<grid_for(ceil_div(n4, kThreads * kUnroll)), kThreads, 0,
           stream>>>(reinterpret_cast<const uint4*>(a),
                     reinterpret_cast<const uint4*>(b), amax, q,
                     reinterpret_cast<uint4*>(f), s, n4);
  } else {
    *path = kElements;
    quantize_elements<T, kSum>
        <<<grid_for(ceil_div(n, kThreads)), kThreads, 0, stream>>>(
            a, b, amax, q, f, s, n, c, pitch);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* a, const void* b, const float* amax, void* q,
                 void* f, float* s, long long n, int c, int pitch, int* path,
                 cudaStream_t st) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  int8_t* tq = static_cast<int8_t*>(q);
  T* tf = static_cast<T*>(f);
  if (b != nullptr)
    return launch<T, true>(ta, tb, amax, tq, tf, s, n, c, pitch, path, st);
  return launch<T, false>(ta, tb, amax, tq, tf, s, n, c, pitch, path, st);
}

}  // namespace

// One launch on `stream`. n elements of C = c channels (n % c == 0), q's
// rows `pitch` bytes apart (a multiple of 16, >= c); b and f both null (q
// of a alone) or both set (the sum); kind 1 float32, 2 bfloat16. The path
// follows the arguments: 16-byte units where C % 16 == 0 and a (b, f) start
// at 16-byte multiples, else element by element; *path says which (0
// flat, 1 elements). Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int quantize_launch(const void* a, const void* b,
                               const float* amax, void* q, void* f, float* s,
                               long long n, int c, int pitch, int kind,
                               int* path, void* stream) {
  if (a == nullptr || amax == nullptr || q == nullptr || s == nullptr ||
      path == nullptr || (b == nullptr) != (f == nullptr) || n < 1 ||
      c < 1 || n % c != 0 || pitch < c || pitch % 16 != 0 ||
      (kind != 1 && kind != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == 1 ? launch_typed<float>(a, b, amax, q, f, s, n, c, pitch,
                                         path, st)
                   : launch_typed<__nv_bfloat16>(a, b, amax, q, f, s, n, c,
                                                 pitch, path, st);
}
