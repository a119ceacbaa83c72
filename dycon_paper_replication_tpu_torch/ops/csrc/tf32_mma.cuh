// The tensor-core helpers of the port's 3xTF32 kernels, K1
// (folded_conv3.cu), K1-dW (folded_conv3_dw.cu) and K2 (fecl_fused.cu):
// 16-byte cp.async copies into shared memory (with the zero-fill form), the
// hi/lo TF32 splits of a float32 operand, fragment loads by ldmatrix, and
// the m16n8k8 TF32 mma.sync with float32 sums. The build hashes this header
// with each source (ops/_build.py), so an edit here rebuilds all three.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes from global `src` to shared `dst`; with `valid` false nothing is
// read and the 16 bytes are zero-filled (source size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo + (below float32 rounding), hi and lo TF32: hi rounded to
// nearest, ties away (cvt.rna.tf32.f32 on finite values), by integer ops on
// the bits; lo = v - hi (exact) truncated to TF32, which keeps a NaN or Inf
// in v non-finite in lo.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// The same split with lo rounded to nearest too (ties away), K1's: hi + lo
// then carries v to 2^-22 of |v| instead of 2^-21. A non-finite v - hi (a
// NaN or Inf v) is truncated instead, so it stays non-finite: rounding would
// carry a NaN's mantissa into its sign.
__device__ __forceinline__ void split_tf32_rn(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  const uint32_t r = __float_as_uint(v - __uint_as_float(hi));
  lo = ((r & 0x7f800000u) == 0x7f800000u ? r : r + 0x1000u) & 0xffffe000u;
}

// Four 8x4 blocks of 32-bit values from shared memory, one register each
// (ldmatrix's four 8x8 b16 matrices, read as pairs): lanes 8 i .. 8 i + 7
// give the 16-byte aligned addresses of block i's rows 0 .. 7, and lane
// (g, t) = (lane / 4, lane % 4) receives element (g, t) of block i in r[i].
// With the blocks a 16x8 tile's quarters (rows 0-7 and 8-15 x columns 0-3,
// then 4-7) that is the m16n8k8 TF32 A fragment, with two 8x8 row-major
// tiles' halves the B fragments of two n8 pieces.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b for one 16x8x8 TF32 tile, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
