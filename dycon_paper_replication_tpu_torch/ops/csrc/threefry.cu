// JAX's threefry2x32 random streams on the card: the train step's teacher
// noise and its fused dropout, drawn at each element's counter as
// jax.random draws them (ops/threefry.py has the plain versions and the
// derivation, out of jax/_src/prng.py and random.py).
//
// Replaces: no Pallas kernel. The JAX package draws these with
// jax.random.normal (train/step.py:191-195, the teacher noise) and
// jax.random.bernoulli (models/layers.py:207-213, dropout), which XLA lowers
// to its own threefry ops fused into the surrounding elementwise work. The
// port needs the same numbers from the same keys, so that its --seed is
// JAX's.
//
// Element i of a tensor of shape (B, ...) takes the counter (i >> 32,
// i & 0xffffffff), i its flat index in JAX's layout (channels-last, or the
// folded layout, both contiguous here) and B the global batch: a
// data-parallel rank passes its rows as two runs (its labeled rows, then its
// unlabeled ones: global row = off0 + j for j < split, else off1 + j -
// split), so each rank draws its own rows of the global draw.
//
//   dycon_threefry_noise: out = clip(0.1 * sqrt(2) * erfinv(u), +-0.2),
//     u uniform in [nextafter(-1, 0), 1), float32. erfinv is XLA's float32
//     polynomial with each step one fused multiply-add, as XLA emits it, and
//     otherwise the plain version's roundings (__fmul_rn, log1pf, IEEE
//     sqrt), so that it equals the plain torch version on the card.
//   dycon_threefry_dropout_{f32,bf16}: y = u < keep ? x / keep : 0 with u
//     uniform in [0, 1) (jax.random.bernoulli), the quotient by keep rounded
//     to x's dtype, in float32, rounded once to x's dtype (JAX's weakly typed
//     division). The backward is the same function of the cotangent with the
//     same key: the mask is recomputed, never stored.
//
// What bounds it on an H100 SXM: integer operations. The hash is 20 rounds
// of add, rotate (one funnel shift) and xor, plus 5 key injections: about 90
// int32 operations an element with the uniform's bit work, against 4 + 4
// bytes (float32 dropout) or 4 bytes (noise) of traffic. At the card's
// ~16.7 T int32 op/s (64 lanes an SM x 132 SMs x 1.98 GHz) against 3.35
// TB/s, the hash takes about 2.7x as long as the bytes. The design keeps to
// that: one element a thread in a grid-stride loop over a row's elements
// (blockIdx.y the local row), 32-bit arithmetic except the 64-bit flat index,
// coalesced loads and stores, nothing staged.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r)                 \
  x0 += x1;                         \
  x1 = __funnelshift_l(x1, x1, r);  \
  x1 ^= x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
}

// 32 random bits of the element at flat index g (jax.random.bits)
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint64_t g) {
  uint32_t x0 = static_cast<uint32_t>(g >> 32), x1 = static_cast<uint32_t>(g);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// [0, 1): the top 23 bits as the mantissa of a float in [1, 2), minus 1
__device__ __forceinline__ float unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

struct Rows {
  int64_t inner, split, off0, off1;
  // the flat index of element e of local row j
  __device__ __forceinline__ uint64_t flat(int64_t j, int64_t e) const {
    const int64_t g = j < split ? off0 + j : off1 + (j - split);
    return static_cast<uint64_t>(g * inner + e);
  }
};

__device__ __forceinline__ float erfinv_xla(float x) {
  const float w0 = -log1pf(__fmul_rn(-x, x));
  float w, p;
  if (w0 < 5.0f) {
    w = __fsub_rn(w0, 2.5f);
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    w = __fsub_rn(__fsqrt_rn(w0), 3.0f);
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return __fmul_rn(p, x);
}

__global__ void noise_kernel(float* __restrict__ out, uint32_t k0, uint32_t k1, Rows rows) {
  const int64_t j = blockIdx.y;
  float* row = out + j * rows.inner;
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float span = 2.0f;        // float32(1 - lo)
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < rows.inner;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float u = fmaxf(lo, __fmaf_rn(unit(bits_at(k0, k1, rows.flat(j, e))), span, lo));
    const float z = __fmul_rn(erfinv_xla(u), 1.41421354f);  // float32(sqrt(2))
    row[e] = fminf(fmaxf(__fmul_rn(0.1f, z), -0.2f), 0.2f);
  }
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ y, uint32_t k0,
                               uint32_t k1, float keep, float divisor, Rows rows) {
  const int64_t j = blockIdx.y;
  const T* xr = x + j * rows.inner;
  T* yr = y + j * rows.inner;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < rows.inner;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool kept = unit(bits_at(k0, k1, rows.flat(j, e))) < keep;
    yr[e] = Elem<T>::store(kept ? __fdiv_rn(Elem<T>::load(xr + e), divisor) : 0.0f);
  }
}

constexpr int kThreads = 256;

dim3 grid(int64_t n_rows, int64_t inner) {
  int64_t bx = (inner + kThreads - 1) / kThreads;
  if (bx > (1 << 20)) bx = 1 << 20;
  return dim3(static_cast<unsigned>(bx > 0 ? bx : 1), static_cast<unsigned>(n_rows));
}

template <typename T>
int launch_dropout(const void* x, void* y, uint32_t k0, uint32_t k1, float keep, float divisor,
                   int64_t n_rows, int64_t inner, int64_t split, int64_t off0, int64_t off1,
                   void* stream) {
  if (n_rows <= 0 || inner <= 0) return 0;
  if (n_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dropout_kernel<T><<<grid(n_rows, inner), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), k0, k1, keep, divisor,
      Rows{inner, split, off0, off1});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dycon_threefry_noise(void* out, uint32_t k0, uint32_t k1, int64_t n_rows,
                                    int64_t inner, int64_t split, int64_t off0, int64_t off1,
                                    void* stream) {
  if (n_rows <= 0 || inner <= 0) return 0;
  if (n_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  noise_kernel<<<grid(n_rows, inner), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), k0, k1, Rows{inner, split, off0, off1});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dycon_threefry_dropout_f32(const void* x, void* y, uint32_t k0, uint32_t k1,
                                          float keep, float divisor, int64_t n_rows,
                                          int64_t inner, int64_t split, int64_t off0,
                                          int64_t off1, void* stream) {
  return launch_dropout<float>(x, y, k0, k1, keep, divisor, n_rows, inner, split, off0, off1,
                               stream);
}

extern "C" int dycon_threefry_dropout_bf16(const void* x, void* y, uint32_t k0, uint32_t k1,
                                           float keep, float divisor, int64_t n_rows,
                                           int64_t inner, int64_t split, int64_t off0,
                                           int64_t off1, void* stream) {
  return launch_dropout<__nv_bfloat16>(x, y, k0, k1, keep, divisor, n_rows, inner, split, off0,
                                       off1, stream);
}
