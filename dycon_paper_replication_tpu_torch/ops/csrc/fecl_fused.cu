// K2: the fused FeCL, forward and closed-form backward, on Hopper's tensor
// cores in three TF32 passes.
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
// ISLES defaults. Done three times on the TF32 tensor cores, that is 16.9 ms
// at 495 TFLOP/s: the bound. This kernel computes 8 products too (four each
// way, below) on mma.sync, whose issue rate with its shared-memory operands
// holds it before that bound (PERF.md; scripts/time_k2.py --variants takes
// it apart).
//
// What the design does about it:
//   * Tensor cores, float32-exact (tf32_mma.cuh, as K1 and K1-dW). Every
//     product, L = F_own F^T, cs = F_own T^T, (dL + dL^T) F and dcs T, runs
//     on m16n8k8 mma.sync: each operand is split into hi (rounded to TF32) and
//     lo = v - hi truncated to TF32 (split_tf32), each 16x8x8 product
//     accumulates lo_a*hi_b, hi_a*lo_b, hi_a*hi_b. A staged value is split
//     once, by the thread that copied it, into a hi and a lo copy in shared
//     memory (K1's scheme); a tile of dL is split once, as it is formed. A
//     NaN or Inf stays non-finite in lo, so a NaN embedding still makes the
//     loss NaN.
//   * Accumulation. The tensor core truncates its float32 sums, so every
//     stage's products go into a fresh float32 sum, added into the running
//     one by a float add rounded to nearest: for L and cs a stage is 32 of
//     the D = 256 features (4 k-steps x 3 passes), for the products over N a
//     stage is 8 streamed rows (one k-step, both of the backward's products).
//     tests/test_torch_fecl_tf32.py emulates this arithmetic against K2's
//     gates.
//   * Blocks. A block of 16 warps owns BM rows of one batch item (128 for the
//     column max and S, 64 otherwise); the other side streams through in
//     tiles of BN = 128 rows (64 in the backward with the teacher, for
//     shared memory). A pair tile is a GEMM over D: each stage of the ring
//     holds 32 features of the block's rows and of the tile's rows (F, and T
//     where cs is needed), so the block's rows are copied again for every
//     tile (from L2: a batch item's F is 9.4 MB) and no more than a ring of
//     stages sits in shared memory. Each warp owns a 32-row piece of the
//     pair tile in m16n8 fragments, loaded by ldmatrix (a staged row is 36
//     floats: the 8 rows of a fragment block hit 8 different 16-byte bank
//     groups). 16 warps, 128 registers a thread: the per-pair epilogue is a
//     long chain of dependent float ops, and a second set of warps hides it
//     (with 8 warps of up to 255 registers the forward took 1.13x as long).
//   * The pair epilogue works on the accumulator fragments: a lane holds
//     rows g and g + 8 and columns 2t and 2t + 1 of each 16 x 8 piece, forms
//     the pair's exp/log/division terms there, and keeps its rows' partial
//     sums (or maxima) over its columns in registers. At the end the 4 lanes
//     of a quad reduce by shuffles and the warps along the tile through
//     shared memory, both in a fixed order. powf stays out of line: inlined
//     into each of an unrolled epilogue's pairs it made the terms launch
//     1.4x slower.
//   * S_i needs the whole row before v_ij can be formed, and M_j the whole
//     column before S. So the forward is three launches over the row tiles,
//     each recomputing L: the column max, then S, then the row terms (the
//     focal and unfocal row sums, rho and the cross sum and count per row,
//     with cs). The column max M is L's row max: the max of row j over its
//     columns stands for the max of column j. L is symmetric in exact
//     arithmetic but not bit for bit here (L_ij and L_ji take their hi*lo and
//     lo*hi passes in another order), so M is the column max within float32
//     rounding; the residual gate (col_max within 1e-5 x max of the twin's)
//     and the loss gate carry it. M is a stop-gradient shift saved for the
//     backward, which reads the saved M, so forward and backward agree. The
//     max propagates NaN (fmaxf would drop it), and the sums multiply by the
//     0/1 pair masks as the JAX code does, so a NaN embedding makes the loss
//     NaN and the step's NaN/Inf skip fires.
//   * dF needs a row reduction (dL F / tau + dcs T) and a column reduction
//     (dL^T F / tau) of the same dL, which is not symmetric (a_i, S_i and
//     rho_i are row quantities). For the block's row i and a streamed row j
//     both dL_ij and dL_ji come from the one dot product f_i . f_j and the
//     O(N) vectors of i and j, and both multiply F_j: dF_i = sum_j (dL_ij +
//     dL_ji) F_j / tau + dcs_ij T_j. So the backward is one launch of four
//     products: L and cs per tile, then (dL + dL^T) / tau times F and dcs
//     times T, each block writing its own rows, no float atomics. Per tile
//     the epilogue forms (dL + dL^T) / tau (and dcs) on the accumulator
//     fragments, splits it and writes it to a shared tile, the A operand of
//     the second product: its rows stride BN + 8 floats, and a lane reads
//     (g, 2t .. 2t + 1) as one 8-byte load that stands for k = t and
//     k = t + 4, so the B operand, 8 streamed rows x 256 features staged at
//     stride 260, is read at rows 2t and 2t + 1: both loads hit 32 banks.
//     dF's running sum (the block's 64 rows) stays in registers, a 32 x 32
//     piece a warp. Every sum runs in a fixed order, so a rerun is
//     bit-identical.
//   * An asynchronous ring of 2 to 4 slots (as many as shared memory
//     holds), copied by cp.async.cg 16 bytes at a time; the copies of the
//     next stages are in flight while a stage computes. Rows past N take the
//     zero-fill form (source size 0) and are masked in the epilogue; nothing
//     is padded.
//
// Eight products, as the JAX algorithm, counted otherwise: the S pass
// recomputes L forward (4 there, 3 in JAX), and the backward's column half
// rides on the row half's L and dL F product (4 there, 5 in JAX).

#include <math.h>

#include "tf32_mma.cuh"

// Design variants for scripts/time_k2.py --variants, never set by the port's
// own build (ops/_build.py): K2_DK and K2_STAGES (another stage width or
// ring depth), and diagnostics whose results are wrong: K2_ONE_PASS
// (hi_a*hi_b only), K2_NO_SPLIT (the staged values used as copied, lo
// planes unset), K2_NO_COPY (no copies), K2_NO_MMA (no products),
// K2_NO_EPILOGUE (no pair terms; the products then go unused and the
// compiler drops them too).
#ifndef K2_DK
#define K2_DK 32
#endif

namespace {

constexpr int DK = K2_DK;    // features per stage of a pair product
constexpr int LDK = DK + 4;  // floats per staged row of a pair product
constexpr int JK = 8;        // streamed rows per stage of a second product (one k-step)
constexpr int SMEM_MAX = 232448;  // shared memory a block can have on an H100
constexpr float EPS = 1e-18f;

enum Mode { COLMAX, ROWSUM, TERMS, BWD };

struct Params {
  const float* F;     // (B, N, D)
  const float* T;     // (B, N, D) or null
  const float* mask;  // (B, N), binary
  // (B, N) residuals read by later launches, and the outputs
  const float* colmax;
  const float* S;
  const float* rho;
  const float* a;
  float* o_colmax;
  float* o_S;
  float* row_sum;
  float* row_unf;
  float* o_rho;
  float* c_sum;
  float* c_cnt;
  float* dF;  // (B, N, D)
  int N;
  float inv_tau;  // 1 / temperature
  float gamma, pos_t, neg_t, g_cross;
  int focal;
};

template <int D, int MODE, bool TEACHER>
struct Cfg {
  // cs (and dcs T) alongside L
  static constexpr int OPS = TEACHER && (MODE == TERMS || MODE == BWD) ? 2 : 1;
  // owned rows per block, streamed rows per tile; 16 warps, WM along the
  // owned rows (32 each) x WN along the tile
  static constexpr int BM = MODE == COLMAX || MODE == ROWSUM ? 128 : 64;
  static constexpr int BN = MODE == BWD && OPS == 2 ? 64 : 128;
  static constexpr int NT = 512;
  static constexpr int WM = BM / 32, WN = NT / 32 / WM;
  static constexpr int MT = 2;                // m16 pieces per warp (32 rows)
  static constexpr int NB = BN / WN / 8;      // n8 pieces per warp
  static constexpr int DN = D / (NT / 64) / 8;  // second product: n8 pieces per warp
  static constexpr int P1 = D / DK;             // pair-product stages per tile
  static constexpr int P2 = MODE == BWD ? BN / JK : 0;  // second-product stages per tile
  static constexpr int LD2 = D + 4;             // floats per staged row of a second product
  static constexpr int PLANE1 = (BM + OPS * BN) * LDK;
  static constexpr int PLANE2 = OPS * JK * LD2;
  // one slot: the hi plane, then the lo plane at + PLANE
  static constexpr int PLANE = PLANE1 > PLANE2 || MODE != BWD ? PLANE1 : PLANE2;
  static constexpr int LDP = BN + 8;                   // floats per row of a dL tile
  // the (dL + dL^T) / tau (and dcs) tiles: hi, then lo at + PTILE
  static constexpr int PTILE = MODE == BWD ? OPS * BM * LDP : 0;
  static constexpr int smem(int stages) { return (stages * 2 * PLANE + 2 * PTILE) * 4; }
  // slots of the ring: as many as fit, at most 4
#ifdef K2_STAGES
  static constexpr int STAGES = K2_STAGES;
#else
  static constexpr int STAGES = smem(4) <= SMEM_MAX ? 4 : (smem(3) <= SMEM_MAX ? 3 : 2);
#endif
  static constexpr int SMEM = smem(STAGES);
};

__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the four floats at `at` split in place into hi, and into lo at at + plane
__device__ __forceinline__ void split4(float* at, int plane) {
  const float4 v = *reinterpret_cast<const float4*>(at);
  uint4 hi, lo;
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(at) = hi;
  *reinterpret_cast<uint4*>(at + plane) = lo;
}

__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
#ifndef K2_NO_MMA
#ifndef K2_ONE_PASS
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
#endif
  mma_tf32(c, ah, bh);
#endif
}

// powf out of line (header: the pair epilogue)
__device__ __noinline__ float pow_any(float x, float g) { return powf(x, g); }

__device__ __forceinline__ float pow_g(float x, float g) {
  return g == 2.f ? x * x : (g == 1.f ? x : pow_any(x, g));
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

// dL_ij (times a_i) from the pair's dot product and the O(N) vectors
__device__ __forceinline__ float dl_pair(float dot, bool diag, float m_i, float m_j, float s_i,
                                         float rho_i, float a_i, float M_j, const Params& p) {
  const float off = diag ? 0.f : 1.f;
  const float e = expf(dot * p.inv_tau * off - M_j);
  const float den = e + s_i + EPS;
  const float v = e / den;
  float phi, psi, logv;
  phi_psi(v, p, phi, psi, logv);
  const float same = m_i == m_j ? 1.f : 0.f;
  const float diff = 1.f - same;
  return a_i * (same * off * psi * (s_i + EPS) * e / (den * den) + rho_i * diff * e);
}

// The block's rows against every streamed tile. Forward modes: the pair
// tiles of L (and cs) and their epilogue, then one value (or five) per row.
// Backward: per tile also (dL + dL^T) / tau (and dcs) into a shared tile and
// the second product into dF's running sum.
template <int D, int MODE, bool TEACHER>
__global__ void __launch_bounds__(Cfg<D, MODE, TEACHER>::NT, 1) fecl_kernel(Params p) {
  using C = Cfg<D, MODE, TEACHER>;
  constexpr int BM = C::BM, BN = C::BN, MT = C::MT, NB = C::NB, OPS = C::OPS, NT = C::NT;
  constexpr int PLANE = C::PLANE, LDP = C::LDP, STAGES = C::STAGES;
  static_assert(MODE != BWD || BM == 64, "the second product's warps own 32 rows of 64");
  constexpr int NQ = MODE == TERMS ? 5 : 1;  // per-row outputs of a forward mode
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* ptile = smem + STAGES * 2 * PLANE;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int b = blockIdx.y, i0 = blockIdx.x * BM, N = p.N;
  const int64_t row0 = int64_t(b) * N;
  const float* F = p.F + row0 * D;
  const float* T = OPS == 2 ? p.T + row0 * D : nullptr;
  const int nstages = (N + BN - 1) / BN * (C::P1 + C::P2);

  // Pair tiles: warp (wm, wn) owns rows wm .. wm + 32 of the block and
  // columns wn .. wn + BN / WN of the tile. Lane (g, t) holds rows
  // wm + 16 mi + g + 8 h (h = 0, 1) of piece mi, indexed r = 2 mi + h, and
  // columns wn + 8 nb + 2 t + x (x = 0, 1), indexed c = 2 nb + x.
  const int wm = (warp % C::WM) * 32, wn = (warp / C::WM) * (BN / C::WN);
  auto own_row = [&](int r) { return wm + 16 * (r >> 1) + g + 8 * (r & 1); };

  // The owned rows' vectors (mask, S, rho, a, M), and the streamed rows'
  // of the current tile, 2 NB a lane. Rows past N: mask -1, the rest 0.
  float om[2 * MT], os[2 * MT], orho[2 * MT], oa[2 * MT], oM[2 * MT];
  float cmask[2 * NB], cs_[2 * NB], crho[2 * NB], ca[2 * NB], cm[2 * NB];
  auto row_vectors = [&](int i, float& m, float& sv, float& rv, float& av, float& Mv) {
    const bool ok = i < N;
    m = ok && MODE != COLMAX ? p.mask[row0 + i] : -1.f;
    sv = ok && (MODE == TERMS || MODE == BWD) ? p.S[row0 + i] : 0.f;
    rv = ok && MODE == BWD ? p.rho[row0 + i] : 0.f;
    av = ok && MODE == BWD ? p.a[row0 + i] : 0.f;
    Mv = ok && MODE != COLMAX ? p.colmax[row0 + i] : 0.f;
  };
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r)
    row_vectors(i0 + own_row(r), om[r], os[r], orho[r], oa[r], oM[r]);
  // the rows' partial results over this lane's columns
  float part[NQ][2 * MT];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) part[q][r] = MODE == COLMAX ? -INFINITY : 0.f;

  // running sums of the pair tile: acc[op][mi][nb] (op 1: cs)
  float acc[OPS][MT][NB][4];
  // backward: dF's running sum, rows wm .. wm + 32 x features wd .. wd + 8 DN
  constexpr int DN = MODE == BWD ? C::DN : 1;
  const int wd = (warp >> 1) * 8 * DN;
  float dacc[MT][DN][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int op = 0; op < OPS; ++op)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) acc[op][mi][nb][e] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < DN; ++n) dacc[mi][n][e] = 0.f;
  }

  // Stage s: tile s / (P1 + P2); r = s % (P1 + P2) < P1 is a pair stage
  // (features DK r .. of the owned rows, then of the tile's F rows, then of
  // its T rows), else a second-product stage (tile rows 8 (r - P1) .. of F,
  // then of T, all D features).
  auto load_stage = [&](int slot, int s) {
#ifdef K2_NO_COPY
    return;
#endif
    float* st = ring + slot * 2 * PLANE;
    const int tile = s / (C::P1 + C::P2), r = s - tile * (C::P1 + C::P2), j0 = tile * BN;
    if (r < C::P1) {
      constexpr int Q = DK / 4;
      for (int e = tid; e < (BM + OPS * BN) * Q; e += NT) {
        const int row = e / Q, q = e - row * Q;
        const int op = row < BM ? 0 : (row - BM) / BN;
        const int gr = row < BM ? i0 + row : j0 + row - BM - op * BN;
        const float* src = op ? T : F;
        const bool ok = gr < N;
        cp_async16(smem_addr(st + row * LDK + 4 * q),
                   ok ? src + int64_t(gr) * D + r * DK + 4 * q : src, ok);
      }
    } else {
      constexpr int Q = D / 4;
      const int jr = j0 + (r - C::P1) * JK;
      for (int e = tid; e < OPS * JK * Q; e += NT) {
        const int row = e / Q, q = e - row * Q;
        const int op = row / JK, gr = jr + row - op * JK;
        const float* src = op ? T : F;
        const bool ok = gr < N;
        cp_async16(smem_addr(st + row * C::LD2 + 4 * q), ok ? src + int64_t(gr) * D + 4 * q : src,
                   ok);
      }
    }
  };

  // The values this thread copied into stage s, once they have landed.
  auto split_stage = [&](int slot, int s) {
#ifdef K2_NO_SPLIT
    return;
#endif
    float* st = ring + slot * 2 * PLANE;
    if (s % (C::P1 + C::P2) < C::P1) {
      constexpr int Q = DK / 4;
      for (int e = tid; e < (BM + OPS * BN) * Q; e += NT)
        split4(st + (e / Q) * LDK + 4 * (e % Q), PLANE);
    } else {
      constexpr int Q = D / 4;
      for (int e = tid; e < OPS * JK * Q; e += NT)
        split4(st + (e / Q) * C::LD2 + 4 * (e % Q), PLANE);
    }
  };

  // The streamed rows' vectors of tile j0, read at its first stage.
  auto load_tile_vectors = [&](int j0) {
#pragma unroll
    for (int c = 0; c < 2 * NB; ++c)
      row_vectors(j0 + wn + 8 * (c >> 1) + 2 * t + (c & 1), cmask[c], cs_[c], crho[c], ca[c],
                  cm[c]);
  };

  // The tile's pairs, once L (and cs) are complete: forward modes add into
  // the rows' partial results; the backward writes (dL + dL^T) / tau (and
  // dcs), split, into the shared tiles.
  auto epilogue = [&](int j0) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float pl[OPS][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mi + (e >> 1), c = 2 * nb + (e & 1);
          const int il = own_row(r), jl = wn + 8 * nb + 2 * t + (e & 1);
          const int i = i0 + il, j = j0 + jl;
          const float L = acc[0][mi][nb][e];
          const float off = i != j ? 1.f : 0.f;
          float dl = 0.f, dcs = 0.f;
          if (MODE == COLMAX) {
            if (j < N) part[0][r] = nanmax(part[0][r], L * p.inv_tau * off);
          } else if (MODE == ROWSUM) {
            if (j < N)
              part[0][r] += expf(L * p.inv_tau * off - cm[c]) * (om[r] == cmask[c] ? 0.f : 1.f);
          } else if (MODE == TERMS) {
            if (j < N) {
              const float ex = expf(L * p.inv_tau * off - cm[c]);
              const float den = ex + os[r] + EPS;
              const float v = ex / den;
              float phi, psi, logv;
              phi_psi(v, p, phi, psi, logv);
              const float same = om[r] == cmask[c] ? 1.f : 0.f;
              const float so = same * off;
              part[0][r] += phi * so;
              part[1][r] += -logv * so;
              part[2][r] += so * psi * (-ex / (den * den));
              if (OPS == 2) {
                const float cs = acc[OPS - 1][mi][nb][e];
                if (same == 0.f && cs > p.neg_t) {
                  part[3][r] += -logf(fmaxf(1.f - cs, 0.f) + EPS);
                  part[4][r] += 1.f;
                }
              }
            }
          } else if (j < N) {  // BWD
            // dL_ij (owned row i, streamed column j) and dL_ji (streamed
            // row j, owned column i) from the same dot product: both
            // multiply F_j in dF_i = sum_j (dL_ij + dL_ji) F_j / tau
            dl = dl_pair(L, i == j, om[r], cmask[c], os[r], orho[r], oa[r], cm[c], p) +
                 dl_pair(L, i == j, cmask[c], om[r], cs_[c], crho[c], ca[c], oM[r], p);
            if (OPS == 2) {
              const float cs = acc[OPS - 1][mi][nb][e];
              if (om[r] != cmask[c] && cs > p.neg_t && cs < 1.f)
                dcs = p.g_cross / (fmaxf(1.f - cs, 0.f) + EPS);
            }
          }
          pl[0][e] = dl * p.inv_tau;
          if (OPS == 2) pl[OPS - 1][e] = dcs;
#pragma unroll
          for (int op = 0; op < OPS; ++op) acc[op][mi][nb][e] = 0.f;
        }
        if (MODE == BWD) {
#pragma unroll
          for (int op = 0; op < OPS; ++op)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint2 hi, lo;
              split_tf32(pl[op][2 * h], hi.x, lo.x);
              split_tf32(pl[op][2 * h + 1], hi.y, lo.y);
              float* at = ptile + op * BM * LDP + own_row(2 * mi + h) * LDP + wn + 8 * nb + 2 * t;
              *reinterpret_cast<uint2*>(at) = hi;
              *reinterpret_cast<uint2*>(at + C::PTILE) = lo;
            }
        }
      }
  };

  // A pair stage: features DK r .. DK (r + 1) of L (and cs) into a fresh
  // sum, added into the running one. The fragments come by ldmatrix; this
  // lane's row addresses (bytes into a plane): an A piece's quarters
  // (row (lane & 7) + 8 ((lane >> 3) & 1), column 4 (lane >> 4)), and two B
  // pieces' halves (row (lane & 7) + 8 (lane >> 4), column 4 ((lane >> 3) &
  // 1)) or, with one B piece a warp, its hi halves and then its lo halves.
  const int lane = tid & 31;
  const uint32_t a_lane = ((wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDK + 4 * (lane >> 4)) * 4;
  const uint32_t b_lane =
      NB == 1 ? ((BM + wn + (lane & 7)) * LDK + 4 * ((lane >> 3) & 1) + (lane >> 4) * PLANE) * 4
              : ((BM + wn + (lane & 7) + 8 * (lane >> 4)) * LDK + 4 * ((lane >> 3) & 1)) * 4;
  auto pair_stage = [&](const float* st) {
    const uint32_t hi = smem_addr(st), lo = hi + PLANE * 4;
    float d[OPS][MT][NB][4];
#pragma unroll
    for (int op = 0; op < OPS; ++op)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[op][mi][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        ldsm_x4(ah[mi], hi + a_lane + (16 * mi * LDK + kk) * 4);
        ldsm_x4(al[mi], lo + a_lane + (16 * mi * LDK + kk) * 4);
      }
#pragma unroll
      for (int op = 0; op < OPS; ++op)
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          const uint32_t o = b_lane + ((op * BN + 8 * nb) * LDK + kk) * 4;
          uint32_t h[4], l[4];
          ldsm_x4(h, hi + o);
          if constexpr (NB == 1) {
            const uint32_t bh[2] = {h[0], h[1]}, bl[2] = {h[2], h[3]};
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) mma3(d[op][mi][nb], ah[mi], al[mi], bh, bl);
          } else {
            ldsm_x4(l, lo + o);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const uint32_t bh[2] = {h[2 * x], h[2 * x + 1]}, bl[2] = {l[2 * x], l[2 * x + 1]};
#pragma unroll
              for (int mi = 0; mi < MT; ++mi)
                mma3(d[op][mi][nb + x], ah[mi], al[mi], bh, bl);
            }
          }
        }
    }
#pragma unroll
    for (int op = 0; op < OPS; ++op)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[op][mi][nb][e] += d[op][mi][nb][e];
  };

  // A second-product stage: tile rows 8 q .. 8 q + 8 (one k-step) of
  // (dL + dL^T) / tau (and dcs) times F (and T) into a fresh sum, added into
  // dF's. The A fragment's k = t and t + 4 stand for the tile's columns
  // 8 q + 2 t and 8 q + 2 t + 1, so B reads the staged rows 2 t and 2 t + 1.
  auto second_stage = [&](const float* st, int q) {
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(st);
    const uint32_t* lo = hi + PLANE;
    const uint32_t* p_hi = reinterpret_cast<const uint32_t*>(ptile);
    const uint32_t* p_lo = p_hi + C::PTILE;
    float d[MT][DN][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mi][n][e] = 0.f;
#pragma unroll
    for (int op = 0; op < OPS; ++op) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int o = op * BM * LDP + (wm + 16 * mi + g) * LDP + 8 * q + 2 * t;
        const uint2 h0 = *reinterpret_cast<const uint2*>(p_hi + o);
        const uint2 h1 = *reinterpret_cast<const uint2*>(p_hi + o + 8 * LDP);
        const uint2 l0 = *reinterpret_cast<const uint2*>(p_lo + o);
        const uint2 l1 = *reinterpret_cast<const uint2*>(p_lo + o + 8 * LDP);
        ah[mi][0] = h0.x;
        ah[mi][1] = h1.x;
        ah[mi][2] = h0.y;
        ah[mi][3] = h1.y;
        al[mi][0] = l0.x;
        al[mi][1] = l1.x;
        al[mi][2] = l0.y;
        al[mi][3] = l1.y;
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const int o = (op * JK + 2 * t) * C::LD2 + wd + 8 * n + g;
        const uint32_t bh[2] = {hi[o], hi[o + C::LD2]}, bl[2] = {lo[o], lo[o + C::LD2]};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma3(d[mi][n], ah[mi], al[mi], bh, bl);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[mi][n][e] += d[mi][n][e];
  };

  auto compute_stage = [&](int slot, int s) {
    const float* st = ring + slot * 2 * PLANE;
    const int tile = s / (C::P1 + C::P2), r = s - tile * (C::P1 + C::P2);
    if (r == 0) load_tile_vectors(tile * BN);
    if (r < C::P1) {
      pair_stage(st);
      // the tile's last pair stage: its epilogue; a backward mode's dL
      // tiles are read after the next stage's barrier
#ifndef K2_NO_EPILOGUE
      if (r == C::P1 - 1) epilogue(tile * BN);
#endif
    } else if (MODE == BWD) {
      second_stage(st, r - C::P1);
    }
  };

  // The ring: stage k waits for its own copies (at most STAGES - 2 younger
  // groups may be pending) and splits them, then a barrier, after which
  // every thread is done with stage k - 1, whose slot takes the copies of
  // stage k + STAGES - 1.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) load_stage(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < nstages; ++k) {
    cp_async_wait<STAGES - 2>();
    split_stage(k % STAGES, k);
    __syncthreads();
    const int next = k + STAGES - 1;
    if (next < nstages) load_stage(next % STAGES, next);
    cp_async_commit();
    compute_stage(k % STAGES, k);
  }
  cp_async_wait<0>();

  if (MODE == BWD) {
    // c0, c1 at (row g, features 2 t, 2 t + 1); c2, c3 at row g + 8
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm + 16 * mi + g + 8 * h;
        if (i >= N) continue;
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          *reinterpret_cast<float2*>(p.dF + (row0 + i) * D + wd + 8 * n + 2 * t) =
              make_float2(dacc[mi][n][2 * h], dacc[mi][n][2 * h + 1]);
        }
      }
    return;
  }

  // Forward: the rows' results over the 4 lanes of a quad (shuffles), then
  // over the 4 warps along the tile (shared memory), in a fixed order.
  __syncthreads();
  float* red = smem;  // [NQ][WN][BM], over the drained ring
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      float v = part[q][r];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = MODE == COLMAX ? nanmax(v, w) : v + w;
      }
      if (t == 0) red[(q * C::WN + warp / C::WM) * BM + own_row(r)] = v;
    }
  __syncthreads();
  if (tid < BM && i0 + tid < N) {
    float* outs[5] = {MODE == COLMAX ? p.o_colmax : (MODE == ROWSUM ? p.o_S : p.row_sum),
                      p.row_unf, p.o_rho, p.c_sum, p.c_cnt};
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float v = red[(q * C::WN) * BM + tid];
#pragma unroll
      for (int w = 1; w < C::WN; ++w) {
        const float x = red[(q * C::WN + w) * BM + tid];
        v = MODE == COLMAX ? nanmax(v, x) : v + x;
      }
      outs[q][row0 + i0 + tid] = v;
    }
  }
}

template <int D, int MODE, bool TEACHER>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  constexpr int BM = Cfg<D, MODE, TEACHER>::BM, NT = Cfg<D, MODE, TEACHER>::NT;
  constexpr int smem = Cfg<D, MODE, TEACHER>::SMEM;
  static_assert(smem <= SMEM_MAX, "K2: shared memory above the H100's 227 KB a block");
  // above the default 48 KB of dynamic shared memory; set on every call, so
  // every device the process launches on gets it
  const cudaError_t err = cudaFuncSetAttribute(
      fecl_kernel<D, MODE, TEACHER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fecl_kernel<D, MODE, TEACHER><<<dim3((p.N + BM - 1) / BM, B), NT, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D, bool TEACHER>
cudaError_t forward(Params p, int B, cudaStream_t st) {
  cudaError_t err;
  if ((err = launch<D, COLMAX, false>(p, B, st)) != cudaSuccess) return err;
  p.colmax = p.o_colmax;
  if ((err = launch<D, ROWSUM, false>(p, B, st)) != cudaSuccess) return err;
  p.S = p.o_S;
  return launch<D, TERMS, TEACHER>(p, B, st);
}

template <int D, bool TEACHER>
cudaError_t backward(const Params& p, int B, cudaStream_t st) {
  return launch<D, BWD, TEACHER>(p, B, st);
}

Params params(const void* F, const void* T, const void* mask, int N, float tau, float gamma,
              float pos_t, float neg_t, int focal) {
  Params p{};
  p.F = static_cast<const float*>(F);
  p.T = static_cast<const float*>(T);
  p.mask = static_cast<const float*>(mask);
  p.N = N;
  p.inv_tau = 1.f / tau;
  p.gamma = gamma;
  p.pos_t = pos_t;
  p.neg_t = neg_t;
  p.focal = focal;
  return p;
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
  Params p = params(F, T, mask, N, tau, gamma, pos_t, neg_t, focal);
  p.o_colmax = static_cast<float*>(colmax);
  p.o_S = static_cast<float*>(S);
  p.row_sum = static_cast<float*>(row_sum);
  p.row_unf = static_cast<float*>(row_unf);
  p.o_rho = static_cast<float*>(rho);
  p.c_sum = static_cast<float*>(c_sum);
  p.c_cnt = static_cast<float*>(c_cnt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 256) err = T ? forward<256, true>(p, B, st) : forward<256, false>(p, B, st);
  return static_cast<int>(err);
}

// The forward's residuals (col_max, S, rho) and a = the per-row weight of
// dL (the cotangent over B N times w, times the gambling weights): (B, N);
// dF: (B, N, D), written. g_cross: the cotangent of the cross sum. Same
// layout rules as the forward. Launches one kernel on `stream` (both halves
// of dF, header) and returns cudaGetLastError().
extern "C" int dycon_fecl_bwd_f32(const void* F, const void* T, const void* mask,
                                  const void* colmax, const void* S, const void* rho,
                                  const void* a, void* dF, int B, int N, int D, float tau,
                                  float gamma, float pos_t, float neg_t, int focal, float g_cross,
                                  void* stream) {
  Params p = params(F, T, mask, N, tau, gamma, pos_t, neg_t, focal);
  p.colmax = static_cast<const float*>(colmax);
  p.S = static_cast<const float*>(S);
  p.rho = static_cast<const float*>(rho);
  p.a = static_cast<const float*>(a);
  p.dF = static_cast<float*>(dF);
  p.g_cross = g_cross;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 256) err = T ? backward<256, true>(p, B, st) : backward<256, false>(p, B, st);
  return static_cast<int>(err);
}
