// K2: the fused FeCL, forward and closed-form backward, in float32 on the
// CUDA cores.
//
// Replaces: dycon_paper_replication_tpu/ops/fecl_fused.py:66, `_build`: the
// custom-VJP core (`_per_item_fwd` :75-137, `_fwd_value` :156-192) and its
// backward `core_bwd` (:201-275), which the JAX package hand-tiles in XLA
// (it has no pallas_call). The function and its gradient are written out in
// ops/fecl_fused.py's module doc: a focal InfoNCE over the B x N x N pairs of
// L2-normalised embeddings F (N = 9216, D = 256 at the ISLES defaults), with
// a column-max shift, and a cross term over the pairs with the teacher's
// embeddings T.
//
// What bounds it on an H100 SXM. The work is B x N x N x D products, each
// fused with exp, log and division per pair and with row or column sums; the
// bytes (F and T, 75.5 MB at the ISLES defaults) are small. The JAX algorithm
// computes three such products forward (column max, L, cs) and five backward
// (L, dL F, cs, dcs T, dL^T F): 8 x 2 B N^2 D = 2.78 TFLOP a step at the
// ISLES defaults, 41.5 ms at the float32 rate of 67 TFLOP/s. This kernel
// recomputes L more often (10 products) and runs them on the CUDA cores, so
// it is bound by operations, and by the shared-memory traffic of its
// register tiles before that.
//
// What the design does about it (a simple kernel that is right first; the
// tensor cores are later work):
//   * No B x N x N matrix leaves the SM. A block owns 64 rows of one batch
//     item and keeps them in shared memory; the other side streams through
//     in steps of 32 rows. Each pair tile (64 x 32) is a dot product over D
//     held in registers (4 x 2 values a thread, float4 shared loads along D,
//     row stride D + 4 so that a quarter-warp's loads hit 32 banks), then
//     turned into the pair's terms in place.
//   * S_i needs the whole row before v_ij can be formed, and M_j the whole
//     column before S. So the forward is three launches over the row tiles,
//     each recomputing L: the column max, then S, then the row terms (the
//     focal and unfocal row sums, rho and the cross sum and count per row).
//     L is symmetric (f_i . f_j, the same products summed in the same d
//     order, so bit-for-bit), so the column max of column j is the row max
//     of row j: a row-owning block computes it, with no float atomics. The
//     max propagates NaN (fmaxf would drop it), and the sums multiply by
//     the 0/1 pair masks as the JAX code does, so a NaN embedding makes the
//     loss NaN and the step's NaN/Inf skip fires.
//   * dF needs a row reduction (dL F / tau + dcs T) and a column reduction
//     (dL^T F / tau) of the same dL, which is not symmetric (a_i, S_i and
//     rho_i are row quantities). Two launches: a row-owning one writes the
//     rows' half, then a column-owning one recomputes dL^T from the O(N)
//     vectors and adds the columns' half. Each writes pair tiles of dL (and
//     dcs) to shared memory and takes the second product from there. No
//     atomics: every sum runs in a fixed order, so a rerun is bit-identical.
//   * Ragged N: tiles past N are zero-filled and masked; nothing is padded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TO = 64;      // rows (columns in fecl_bwd_cols_kernel) a block owns
constexpr int TK = 32;      // rows of the other side per step
constexpr int NT = 256;     // 16 x 16 threads: ty picks 4 owned rows, tx 2 other rows
constexpr int LP = TK + 1;  // row stride of the pair tiles in shared memory
constexpr float EPS = 1e-18f;

struct Params {
  const float* F;     // (B, N, D)
  const float* T;     // (B, N, D) or null
  const float* mask;  // (B, N), binary
  int N;
  float tau, gamma, pos_t, neg_t;
  int focal;
};

template <int D>
__host__ __device__ constexpr int ld() {
  return D + 4;
}

__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ void fma4(float& s, float4 a, float4 b) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  s = fmaf(a.w, b.w, s);
}

// rows [r0, r0 + rows) of one item's (N, D) matrix into shared memory at row
// stride D + 4; rows at or past N are zero
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int rows, int N) {
  constexpr int Q = D / 4;
  for (int e = threadIdx.x; e < rows * Q; e += NT) {
    const int r = e / Q, q = e - r * Q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) v = __ldg(reinterpret_cast<const float4*>(src + int64_t(r0 + r) * D) + q);
    *reinterpret_cast<float4*>(dst + r * ld<D>() + 4 * q) = v;
  }
}

// acc[r][c] = own row (ty + 16 r) . oth row (tx + 16 c), and with TWO
// acc2[r][c] the same against oth2; summed over d in order
template <int D, bool TWO>
__device__ __forceinline__ void dot_tile(const float* own, const float* oth, const float* oth2,
                                         float (&acc)[4][2], float (&acc2)[4][2]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[r][c] = acc2[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[2], t[2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(own + (ty + 16 * r) * ld<D>() + d);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      b[c] = *reinterpret_cast<const float4*>(oth + (tx + 16 * c) * ld<D>() + d);
      if (TWO) t[c] = *reinterpret_cast<const float4*>(oth2 + (tx + 16 * c) * ld<D>() + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        fma4(acc[r][c], a[r], b[c]);
        if (TWO) fma4(acc2[r][c], a[r], t[c]);
      }
  }
}

// acc[r][c] (the 4 values at d = 4 tx + 64 c) += sum_k P[ty + 16 r][k] X[k][d]
template <int D>
__device__ __forceinline__ void pair_gemm(const float* P, const float* X, float4 (&acc)[4][D / 64]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < TK; ++k) {
    float pv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = P[(ty + 16 * r) * LP + k];
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(X + k * ld<D>() + 4 * tx + 64 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][c].x = fmaf(pv[r], x.x, acc[r][c].x);
        acc[r][c].y = fmaf(pv[r], x.y, acc[r][c].y);
        acc[r][c].z = fmaf(pv[r], x.z, acc[r][c].z);
        acc[r][c].w = fmaf(pv[r], x.w, acc[r][c].w);
      }
    }
  }
}

// sum (or NaN-propagating max) over the 16 lanes that share ty, in a fixed order
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lane_max(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float pow_g(float x, float g) {
  return g == 2.f ? x * x : (g == 1.f ? x : powf(x, g));
}

// phi(v), psi(v) = phi'(v) and log(v + eps) (ops/fecl_fused.py: _phi_psi)
__device__ __forceinline__ void phi_psi(float v, const Params& p, float& phi, float& psi,
                                        float& logv) {
  logv = logf(v + EPS);
  if (!p.focal) {
    phi = -logv;
    psi = -1.f / (v + EPS);
    return;
  }
  const bool hard = v < p.pos_t;
  const float om = 1.f - v;
  const float c = hard ? pow_g(om, p.gamma) : 1.f;
  const float dc = hard ? -p.gamma * pow_g(om, p.gamma - 1.f) : 0.f;
  phi = -logv * c;
  psi = -c / (v + EPS) - logv * dc;
}

// ---- forward ----

// colmax[b, i] = max_j L_ij with L_ii = 0 (= the column max, L symmetric)
template <int D>
__global__ void __launch_bounds__(NT) fecl_colmax_kernel(Params p, float* __restrict__ colmax) {
  extern __shared__ float4 smem4[];
  float* own = reinterpret_cast<float*>(smem4);
  float* oth = own + TO * ld<D>();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y, i0 = blockIdx.x * TO, N = p.N;
  const float* F = p.F + int64_t(b) * N * D;
  load_rows<D>(own, F, i0, TO, N);
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int j0 = 0; j0 < N; j0 += TK) {
    __syncthreads();
    load_rows<D>(oth, F, j0, TK, N);
    __syncthreads();
    float L[4][2], unused[4][2];
    dot_tile<D, false>(own, oth, nullptr, L, unused);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (j < N) m[r] = nanmax(m[r], L[r][c] / p.tau * (i != j ? 1.f : 0.f));
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v = lane_max(m[r]);
    const int i = i0 + ty + 16 * r;
    if (tx == 0 && i < N) colmax[int64_t(b) * N + i] = v;
  }
}

// S[b, i] = sum_j exp(L_ij - M_j) diff_ij
template <int D>
__global__ void __launch_bounds__(NT) fecl_rowsum_kernel(Params p, const float* __restrict__ colmax,
                                                        float* __restrict__ S) {
  extern __shared__ float4 smem4[];
  float* own = reinterpret_cast<float*>(smem4);
  float* oth = own + TO * ld<D>();
  float* cm = oth + TK * ld<D>();
  float* cmask = cm + TK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y, i0 = blockIdx.x * TO, N = p.N;
  const int64_t row0 = int64_t(b) * N;
  const float* F = p.F + row0 * D;
  load_rows<D>(own, F, i0, TO, N);
  float mi[4], s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    mi[r] = i < N ? p.mask[row0 + i] : -1.f;
    s[r] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += TK) {
    __syncthreads();
    load_rows<D>(oth, F, j0, TK, N);
    if (threadIdx.x < TK) {
      const int j = j0 + threadIdx.x;
      cm[threadIdx.x] = j < N ? colmax[row0 + j] : 0.f;
      cmask[threadIdx.x] = j < N ? p.mask[row0 + j] : -1.f;
    }
    __syncthreads();
    float L[4][2], unused[4][2];
    dot_tile<D, false>(own, oth, nullptr, L, unused);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + ty + 16 * r, jl = tx + 16 * c, j = j0 + jl;
        if (j < N) {
          const float e = expf(L[r][c] / p.tau * (i != j ? 1.f : 0.f) - cm[jl]);
          s[r] += e * (mi[r] == cmask[jl] ? 0.f : 1.f);
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v = lane_sum(s[r]);
    const int i = i0 + ty + 16 * r;
    if (tx == 0 && i < N) S[row0 + i] = v;
  }
}

// per row: the focal and unfocal sums over its positives, rho, and the
// cross term's sum and count over its hard negatives
template <int D, bool TEACHER>
__global__ void __launch_bounds__(NT) fecl_terms_kernel(
    Params p, const float* __restrict__ colmax, const float* __restrict__ S,
    float* __restrict__ row_sum, float* __restrict__ row_unf, float* __restrict__ rho,
    float* __restrict__ c_sum, float* __restrict__ c_cnt) {
  extern __shared__ float4 smem4[];
  float* own = reinterpret_cast<float*>(smem4);
  float* othF = own + TO * ld<D>();
  float* othT = othF + TK * ld<D>();
  float* cm = othT + (TEACHER ? TK * ld<D>() : 0);
  float* cmask = cm + TK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y, i0 = blockIdx.x * TO, N = p.N;
  const int64_t row0 = int64_t(b) * N;
  const float* F = p.F + row0 * D;
  const float* T = TEACHER ? p.T + row0 * D : nullptr;
  load_rows<D>(own, F, i0, TO, N);
  float mi[4], si[4], rs[4], ru[4], rh[4], c1[4], c2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    mi[r] = i < N ? p.mask[row0 + i] : -1.f;
    si[r] = i < N ? S[row0 + i] : 0.f;
    rs[r] = ru[r] = rh[r] = c1[r] = c2[r] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += TK) {
    __syncthreads();
    load_rows<D>(othF, F, j0, TK, N);
    if (TEACHER) load_rows<D>(othT, T, j0, TK, N);
    if (threadIdx.x < TK) {
      const int j = j0 + threadIdx.x;
      cm[threadIdx.x] = j < N ? colmax[row0 + j] : 0.f;
      cmask[threadIdx.x] = j < N ? p.mask[row0 + j] : -1.f;
    }
    __syncthreads();
    float L[4][2], C[4][2];
    dot_tile<D, TEACHER>(own, othF, othT, L, C);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + ty + 16 * r, jl = tx + 16 * c, j = j0 + jl;
        if (j >= N) continue;
        const float off = i != j ? 1.f : 0.f;
        const float e = expf(L[r][c] / p.tau * off - cm[jl]);
        const float den = e + si[r] + EPS;
        const float v = e / den;
        float phi, psi, logv;
        phi_psi(v, p, phi, psi, logv);
        const float same = mi[r] == cmask[jl] ? 1.f : 0.f;
        const float so = same * off;
        rs[r] += phi * so;
        ru[r] += -logv * so;
        rh[r] += so * psi * (-e / (den * den));
        if (TEACHER) {
          const float cs = C[r][c];
          if (same == 0.f && cs > p.neg_t) {
            c1[r] += -logf(fmaxf(1.f - cs, 0.f) + EPS);
            c2[r] += 1.f;
          }
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v_rs = lane_sum(rs[r]), v_ru = lane_sum(ru[r]), v_rh = lane_sum(rh[r]);
    const float v_c1 = lane_sum(c1[r]), v_c2 = lane_sum(c2[r]);
    const int i = i0 + ty + 16 * r;
    if (tx == 0 && i < N) {
      row_sum[row0 + i] = v_rs;
      row_unf[row0 + i] = v_ru;
      rho[row0 + i] = v_rh;
      c_sum[row0 + i] = v_c1;
      c_cnt[row0 + i] = v_c2;
    }
  }
}

// ---- backward ----

// dL_ij (times a_i) from the pair's dot product and the O(N) vectors
__device__ __forceinline__ float dl_pair(float dot, bool diag, float m_i, float m_j, float s_i,
                                         float rho_i, float a_i, float M_j, const Params& p) {
  const float off = diag ? 0.f : 1.f;
  const float e = expf(dot / p.tau * off - M_j);
  const float den = e + s_i + EPS;
  const float v = e / den;
  float phi, psi, logv;
  phi_psi(v, p, phi, psi, logv);
  const float same = m_i == m_j ? 1.f : 0.f;
  const float diff = 1.f - same;
  return a_i * (same * off * psi * (s_i + EPS) * e / (den * den) + rho_i * diff * e);
}

// dF[b, i] = sum_j dL_ij F_j / tau + sum_j dcs_ij T_j for the 64 rows i a block owns
template <int D, bool TEACHER>
__global__ void __launch_bounds__(NT, 1) fecl_bwd_rows_kernel(
    Params p, const float* __restrict__ colmax, const float* __restrict__ S,
    const float* __restrict__ rho, const float* __restrict__ a, float g_cross,
    float* __restrict__ dF) {
  extern __shared__ float4 smem4[];
  float* own = reinterpret_cast<float*>(smem4);
  float* othF = own + TO * ld<D>();
  float* othT = othF + TK * ld<D>();
  float* P1 = othT + (TEACHER ? TK * ld<D>() : 0);
  float* P2 = P1 + TO * LP;
  float* cm = P2 + (TEACHER ? TO * LP : 0);
  float* cmask = cm + TK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y, i0 = blockIdx.x * TO, N = p.N;
  const int64_t row0 = int64_t(b) * N;
  const float* F = p.F + row0 * D;
  const float* T = TEACHER ? p.T + row0 * D : nullptr;
  load_rows<D>(own, F, i0, TO, N);
  float mi[4], si[4], ri[4], ai[4];
  float4 accL[4][D / 64], accC[4][D / 64];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    const bool ok = i < N;
    mi[r] = ok ? p.mask[row0 + i] : -1.f;
    si[r] = ok ? S[row0 + i] : 0.f;
    ri[r] = ok ? rho[row0 + i] : 0.f;
    ai[r] = ok ? a[row0 + i] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) accL[r][c] = accC[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j0 = 0; j0 < N; j0 += TK) {
    __syncthreads();
    load_rows<D>(othF, F, j0, TK, N);
    if (TEACHER) load_rows<D>(othT, T, j0, TK, N);
    if (threadIdx.x < TK) {
      const int j = j0 + threadIdx.x;
      cm[threadIdx.x] = j < N ? colmax[row0 + j] : 0.f;
      cmask[threadIdx.x] = j < N ? p.mask[row0 + j] : -1.f;
    }
    __syncthreads();
    float L[4][2], C[4][2];
    dot_tile<D, TEACHER>(own, othF, othT, L, C);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + ty + 16 * r, jl = tx + 16 * c, j = j0 + jl;
        float dl = 0.f, dcs = 0.f;
        if (j < N) {
          dl = dl_pair(L[r][c], i == j, mi[r], cmask[jl], si[r], ri[r], ai[r], cm[jl], p);
          if (TEACHER) {
            const float cs = C[r][c];
            if (mi[r] != cmask[jl] && cs > p.neg_t && cs < 1.f)
              dcs = g_cross / (fmaxf(1.f - cs, 0.f) + EPS);
          }
        }
        P1[(ty + 16 * r) * LP + jl] = dl;
        if (TEACHER) P2[(ty + 16 * r) * LP + jl] = dcs;
      }
    __syncthreads();
    pair_gemm<D>(P1, othF, accL);
    if (TEACHER) pair_gemm<D>(P2, othT, accC);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float4 l = accL[r][c], x = accC[r][c];
      *reinterpret_cast<float4*>(dF + (row0 + i) * D + 4 * tx + 64 * c) =
          make_float4(l.x / p.tau + x.x, l.y / p.tau + x.y, l.z / p.tau + x.z, l.w / p.tau + x.w);
    }
  }
}

// dF[b, j] += sum_i dL_ij F_i / tau for the 64 columns j a block owns
template <int D>
__global__ void __launch_bounds__(NT, 1) fecl_bwd_cols_kernel(
    Params p, const float* __restrict__ colmax, const float* __restrict__ S,
    const float* __restrict__ rho, const float* __restrict__ a, float* __restrict__ dF) {
  extern __shared__ float4 smem4[];
  float* own = reinterpret_cast<float*>(smem4);
  float* oth = own + TO * ld<D>();
  float* P1 = oth + TK * ld<D>();
  float* rS = P1 + TO * LP;
  float* rR = rS + TK;
  float* rA = rR + TK;
  float* rM = rA + TK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y, j0 = blockIdx.x * TO, N = p.N;
  const int64_t row0 = int64_t(b) * N;
  const float* F = p.F + row0 * D;
  load_rows<D>(own, F, j0, TO, N);
  float mj[4], Mj[4];
  float4 acc[4][D / 64];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    mj[r] = j < N ? p.mask[row0 + j] : -1.f;
    Mj[r] = j < N ? colmax[row0 + j] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i0 = 0; i0 < N; i0 += TK) {
    __syncthreads();
    load_rows<D>(oth, F, i0, TK, N);
    if (threadIdx.x < TK) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < N;
      rS[threadIdx.x] = ok ? S[row0 + i] : 0.f;
      rR[threadIdx.x] = ok ? rho[row0 + i] : 0.f;
      rA[threadIdx.x] = ok ? a[row0 + i] : 0.f;
      rM[threadIdx.x] = ok ? p.mask[row0 + i] : -1.f;
    }
    __syncthreads();
    float L[4][2], unused[4][2];
    dot_tile<D, false>(own, oth, nullptr, L, unused);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + ty + 16 * r, il = tx + 16 * c, i = i0 + il;
        const float dl = i < N ? dl_pair(L[r][c], i == j, rM[il], mj[r], rS[il], rR[il],
                                         rA[il], Mj[r], p)
                               : 0.f;
        P1[(ty + 16 * r) * LP + il] = dl;
      }
    __syncthreads();
    pair_gemm<D>(P1, oth, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= N) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      float4* out = reinterpret_cast<float4*>(dF + (row0 + j) * D + 4 * tx + 64 * c);
      const float4 d = *out, s = acc[r][c];
      *out = make_float4(d.x + s.x / p.tau, d.y + s.y / p.tau, d.z + s.z / p.tau,
                         d.w + s.w / p.tau);
    }
  }
}

// ---- launches ----

// above the default 48 KB of dynamic shared memory; set on every call, so
// every device the process launches on gets it
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int D, bool TEACHER>
cudaError_t forward(const Params& p, int B, float* colmax, float* S, float* row_sum,
                    float* row_unf, float* rho, float* c_sum, float* c_cnt, cudaStream_t st) {
  const dim3 grid((p.N + TO - 1) / TO, B);
  const size_t tiles = size_t(TO + TK) * ld<D>() * sizeof(float);
  const size_t vec = 2 * TK * sizeof(float);
  const size_t terms = tiles + (TEACHER ? size_t(TK) * ld<D>() * sizeof(float) : 0) + vec;
  cudaError_t err;
  if ((err = allow_smem(fecl_colmax_kernel<D>, tiles)) != cudaSuccess) return err;
  fecl_colmax_kernel<D><<<grid, NT, tiles, st>>>(p, colmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(fecl_rowsum_kernel<D>, tiles + vec)) != cudaSuccess) return err;
  fecl_rowsum_kernel<D><<<grid, NT, tiles + vec, st>>>(p, colmax, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(fecl_terms_kernel<D, TEACHER>, terms)) != cudaSuccess) return err;
  fecl_terms_kernel<D, TEACHER><<<grid, NT, terms, st>>>(p, colmax, S, row_sum, row_unf, rho,
                                                         c_sum, c_cnt);
  return cudaGetLastError();
}

template <int D, bool TEACHER>
cudaError_t backward(const Params& p, int B, const float* colmax, const float* S,
                     const float* rho, const float* a, float g_cross, float* dF,
                     cudaStream_t st) {
  const dim3 grid((p.N + TO - 1) / TO, B);
  const size_t tile = size_t(ld<D>()) * sizeof(float);
  const size_t pairs = size_t(TO) * LP * sizeof(float);
  const size_t rows = (TO + (TEACHER ? 2 : 1) * TK) * tile + (TEACHER ? 2 : 1) * pairs +
                      2 * TK * sizeof(float);
  const size_t cols = (TO + TK) * tile + pairs + 4 * TK * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(fecl_bwd_rows_kernel<D, TEACHER>, rows)) != cudaSuccess) return err;
  fecl_bwd_rows_kernel<D, TEACHER><<<grid, NT, rows, st>>>(p, colmax, S, rho, a, g_cross, dF);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(fecl_bwd_cols_kernel<D>, cols)) != cudaSuccess) return err;
  fecl_bwd_cols_kernel<D><<<grid, NT, cols, st>>>(p, colmax, S, rho, a, dF);
  return cudaGetLastError();
}

Params params(const void* F, const void* T, const void* mask, int N, float tau, float gamma,
              float pos_t, float neg_t, int focal) {
  return Params{static_cast<const float*>(F), static_cast<const float*>(T),
                static_cast<const float*>(mask), N, tau, gamma, pos_t, neg_t, focal};
}

}  // namespace

// F, T (or null): (B, N, D); mask and the seven outputs (col_max, S, the
// focal and unfocal row sums, rho, the cross sum and count per row): (B, N);
// float32, contiguous, 16-byte aligned; D == 256 (the wrapper
// checks). Launches three kernels on `stream`; returns cudaGetLastError().
extern "C" int dycon_fecl_fwd_f32(const void* F, const void* T, const void* mask, void* colmax,
                                  void* S, void* row_sum, void* row_unf, void* rho, void* c_sum,
                                  void* c_cnt, int B, int N, int D, float tau, float gamma,
                                  float pos_t, float neg_t, int focal, void* stream) {
  const Params p = params(F, T, mask, N, tau, gamma, pos_t, neg_t, focal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o[7] = {static_cast<float*>(colmax), static_cast<float*>(S),
                 static_cast<float*>(row_sum), static_cast<float*>(row_unf),
                 static_cast<float*>(rho), static_cast<float*>(c_sum),
                 static_cast<float*>(c_cnt)};
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 256)
    err = T ? forward<256, true>(p, B, o[0], o[1], o[2], o[3], o[4], o[5], o[6], st)
            : forward<256, false>(p, B, o[0], o[1], o[2], o[3], o[4], o[5], o[6], st);
  return static_cast<int>(err);
}

// The forward's residuals (col_max, S, rho) and a = the per-row weight of
// dL (the cotangent over B N times w, times the gambling weights): (B, N);
// dF: (B, N, D), written. g_cross: the cotangent of the cross sum. Same
// layout rules as the forward. Launches two kernels on `stream` (the rows'
// half of dF, then the columns' half added in).
extern "C" int dycon_fecl_bwd_f32(const void* F, const void* T, const void* mask,
                                  const void* colmax, const void* S, const void* rho,
                                  const void* a, void* dF, int B, int N, int D, float tau,
                                  float gamma, float pos_t, float neg_t, int focal, float g_cross,
                                  void* stream) {
  const Params p = params(F, T, mask, N, tau, gamma, pos_t, neg_t, focal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cm = static_cast<const float*>(colmax);
  const float* s = static_cast<const float*>(S);
  const float* r = static_cast<const float*>(rho);
  const float* av = static_cast<const float*>(a);
  float* d = static_cast<float*>(dF);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 256)
    err = T ? backward<256, true>(p, B, cm, s, r, av, g_cross, d, st)
            : backward<256, false>(p, B, cm, s, r, av, g_cross, d, st);
  return static_cast<int>(err);
}
