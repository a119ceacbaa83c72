// The tensor-core helpers of the port's bfloat16 kernels, K1-bf16
// (folded_conv3.cu) and K1-dW-bf16 (folded_conv3_dw.cu): the m16n8k16 bf16
// mma.sync with float32 sums, the transposed ldmatrix that gives the
// fragment of an operand stored MN-major, and the round-to-nearest-even
// store of two float32 sums as bf16. The copies into shared memory and the
// non-transposed ldmatrix are tf32_mma.cuh's. The build hashes this header
// with every source (ops/_build.py).

#pragma once

#include <cuda_bf16.h>

#include "tf32_mma.cuh"

namespace {

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8 i .. 8 i + 7
// give the 16-byte aligned addresses of matrix i's rows 0 .. 7, and lane
// (g, t) = (lane / 4, lane % 4) receives elements (rows 2 t, 2 t + 1;
// column g) of matrix i in r[i], the lower row in the lower half. With a
// matrix's rows along K and its columns along M (or N), that is one
// register of an m16n8k16 A (or B) fragment: any 16-bit operand stored
// with M (or N) contiguous, one row address per lane.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b for one 16x8x16 bf16 tile, float32 accumulation. The products
// of two bf16 values are exact in float32; the sums are not rounded to
// nearest (the callers keep short fresh sums, see their headers).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (a, b) rounded to bf16 to nearest even (a NaN stays a NaN), as one word:
// a in the lower half, the lower address.
__device__ __forceinline__ __nv_bfloat162 pack_bf16_rn(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

}  // namespace
