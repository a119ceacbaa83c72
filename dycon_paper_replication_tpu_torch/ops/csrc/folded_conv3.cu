// K1: the fold-2 3^3 SAME conv as a dense 2^3-tap conv over the folded grid,
// on Hopper's tensor cores in three TF32 passes.
//
// Replaces: dycon_paper_replication_tpu/ops/folded_conv_pallas.py,
// folded_conv3_pallas (body _kernel), the TPU kernel that the JAX package
// reaches through ops/folding.py:folded_conv3. Same function, without bias:
//
//   y[b, q, n] = sum_{t in {0,1}^3} sum_k x[b, q + t + off, k] * wf[t, k, n]
//
// with off = -1 for to_phase = 1 (grid G -> G+1, pad (1,1)) and off = 0 for
// to_phase = 0 (grid G -> G-1, VALID). Reads outside the input grid count as
// zero; the pad is never materialised. The same kernel serves the backward's
// dx of the custom VJP (`_conv_wf_bwd`): dy through the taps flipped and
// transposed, in the opposite phase (ops/folded_conv_cuda.py:FoldedConv3Fn).
//
// What bounds it on an H100 SXM. As a GEMM it is y (M = B*Q1*Q2*Q3 output
// voxels by N = L_out) = A wf over K = 8*L_in (tap, lane), so
// FLOPs = 2 M N K. Each product is done three times on the TF32 tensor cores
// (below), so the operation bound is 3 x FLOPs over 495 TFLOP/s dense TF32;
// the byte bound is x and wf read once and y written once over 3.35 TB/s.
// The operation bound is the larger at every shape of the UNet but
// L_in = 8 (conv1.conv1, K = 64), which is bound by the bytes of y (652 MB
// at the training shape).
//
// What the design does about it:
//   * Tensor cores, float32-exact, with the helpers of K1-dW
//     (tf32_mma.cuh). Each operand is split into hi (rounded to TF32 by two
//     integer ops) and lo = v - hi, rounded to TF32 too (split_tf32_rn;
//     K1-dW truncates lo), so hi + lo is within 2^-22 of v, not 2^-21 (with
//     lo truncated, the card's train step fell on the other side of a ReLU
//     kink of its check against the CPU; PERF.md); a NaN or Inf in v stays
//     non-finite in lo. Each m16n8k8 product accumulates lo_a*hi_b,
//     then hi_a*lo_b, then hi_a*hi_b, small terms first. The staged input
//     is split once, by the thread that copied it, into a hi and a lo copy
//     in shared memory: every staged value is read by 4 warps at up to 8
//     taps, so splitting at each fragment load did it up to 32 times. wf's
//     values are read twice a stage and are split at fragment load.
//   * Accumulation: the passes of a stage (8 taps x 8 lanes, 24 mma) go
//     into a fresh float32 sum, added into the running sum by one float add
//     rounded to nearest. The tensor core does not round its sums to
//     nearest; tests/test_torch_tf32.py emulates it (exact products, sums
//     truncated toward zero) over K = 8 L_in. Straight into the running sum
//     the max error is 3.2e-5 at L_in 128 and 1.8e-4 at L_in 768 against a
//     gate of 3.1e-4 / 3.6e-4 (1e-4 x max|y|): half the gate at the widest
//     conv (on the card, 2.6e-4 at up_concat2.conv1), for 1 % of the time.
//     With the stage sums the card's rms error against float64 is 4.3e-7
//     to 4.7e-7 at the training shapes, where cuDNN's float32 conv's is
//     1.4e-7 (L_in 8) to 1.3e-6; a fresh sum per tap and 16 x 8 piece
//     (K1_TAP_SUMS) lowers it to 1.0e-7 to 4.6e-7 at 1.18x the time
//     (scripts/k1_variants.py; PERF.md).
//   * Tap reuse. An output tile is a run of BM voxels of one (b, qd) plane
//     in a padded row order: m = qh * Wv + c, rows of Wv = SW + 1 columns,
//     of which the last is never written. In that order the input voxel of
//     tap (td, th, tw) sits at a fixed row offset td * HR + th * Wv + tw
//     from the output's, so per lane chunk the block stages its input halo
//     once, two d-planes x HR = BM + Wv + 1 rows, and reads all 8 taps from
//     it at their offsets. An input voxel crosses from L2 into shared
//     memory 2 HR / BM ~ 2.4-2.9 times per output tile, where a per-tap
//     gather moved it 8 times. A row of the halo outside the grid (the pad,
//     the tail) is zero-filled by the copy. Grids wider than SEG = 64
//     output columns are cut into equal segments of SW <= 64 columns, each
//     its own tiles, so shared memory does not grow with the grid.
//   * mma.sync, not wgmma. The tap offsets move the A tile by one row at a
//     time, which wgmma's 8-row core matrices in shared memory cannot
//     follow; mma.sync.m16n8k8 reads its fragments by plain shared loads at
//     any row. A staged voxel row is BK = 8 lanes padded to 12 floats, a
//     wf row BN = 128 lanes padded to 136, so every fragment load of a warp
//     hits 32 different banks. wf needs no reordering: wf[t, k, :] is a
//     contiguous row of N for each (tap, lane).
//   * An asynchronous ring: 3 stages of one lane chunk (the halo's 8 lanes
//     and wf's 8 taps x 8 lanes x 128), cp.async.cg 16 bytes at a time into
//     dynamic shared memory (72,064 bytes a stage with the halo's hi and lo
//     copies, 219 KB with the halo's row table). Each halo row's offset in x
//     (or -1 outside the grid) is computed once per block into that table:
//     no division per stage.
//   * Tiles: a block of 8 warps owns BM = 128 rows x BN = 128 lanes, each
//     warp 64 x 32, with its running and its stage sums (64 each a thread)
//     in registers: one block per SM. L_in = 8 (conv1.conv1, bound by the
//     bytes of y) is one stage, whose sum is the running sum: it takes
//     one slot (75 KB) and no separate stage sums, two blocks per SM, so
//     one block's loads and mma overlap another's y stores.
//
// Design variants for scripts/k1_variants.py, never defined by the port's
// own build (ops/_build.py): K1_ONE_PASS (hi_a*hi_b only), K1_TAP_SUMS (a
// fresh sum per tap and 16 x 8 piece), K1_RUNNING_SUM (no fresh sums),
// K1_NO_REUSE (each tap stages its own BM input rows and its own wf slice,
// one tap per stage: the traffic of a per-tap gather).

#include "tf32_mma.cuh"

namespace {

constexpr int BM = 128;      // output rows (voxels in padded row order) per block
constexpr int BN = 128;      // output lanes per block
constexpr int BK = 8;        // input lanes per stage
constexpr int NT = 256;      // threads: 8 warps, 2 along the rows x 4 along the lanes
constexpr int SEG = 64;      // output columns per segment, at most
constexpr int LDA = BK + 4;  // floats per staged input voxel
constexpr int LDB = BN + 8;  // floats per staged wf row

// Shared memory: the halo's row table (an int64 per row), then a slot per
// ring stage, each the halo (2 d-planes of at most BM + SEG + 2 rows) as
// TF32 hi, the same as TF32 lo, and wf's 8 taps x BK lanes as float32.
constexpr int HR_MAX = BM + SEG + 2;  // halo rows per d-plane, at most (BM + Wv + 1)
constexpr int A_FLOATS = 2 * HR_MAX * LDA;
constexpr int STAGE_FLOATS = 2 * A_FLOATS + 8 * BK * LDB;
constexpr int TABLE_FLOATS = 2 * HR_MAX * 2;

constexpr int smem_bytes(int slots) { return (TABLE_FLOATS + slots * STAGE_FLOATS) * 4; }

// The number of ring stages of one launch: one per lane chunk (one per lane
// chunk and tap under K1_NO_REUSE).
__host__ __device__ inline int ring_stages(int Lin) {
#ifdef K1_NO_REUSE
  return 8 * (Lin / BK);
#else
  return Lin / BK;
#endif
}

// STAGE_SUMS false: every pass straight into the running sum, which for a
// single stage (L_in = 8) is the same sum: 0 + d == d.
template <int STAGES, int MIN_BLOCKS, bool STAGE_SUMS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
folded_conv3_kernel(const float* __restrict__ x, const float* __restrict__ wf,
                    float* __restrict__ y, int G1, int G2, int G3, int Lin, int Lout,
                    int Q1, int Q2, int Q3, int off, int SW, int mtiles) {
  constexpr int MT = BM / 32;  // 16-row tiles per warp
  extern __shared__ __align__(16) float smem[];
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem);
  float* ring = smem + TABLE_FLOATS;

  const int tid = threadIdx.x;
  const int Wv = SW + 1;
  const int HR = BM + Wv + 1;
  const int seg = blockIdx.x / mtiles;
  const int m0 = (blockIdx.x - seg * mtiles) * BM;
  const int w0 = seg * SW;
  const int n0 = blockIdx.y * BN;
  const int bq = blockIdx.z;  // b * Q1 + qd
  const int b = bq / Q1;
  const int qd = bq - b * Q1;

  // Halo row i: d-plane td = i / HR, padded position p = m0 + i - td * HR,
  // i.e. input voxel (qd + td, p / Wv, w0 + p % Wv) + off.
  for (int i = tid; i < 2 * HR; i += NT) {
    const int td = i >= HR;
    const int p = m0 + i - td * HR;
    const int hp = p / Wv;
    const int id = qd + td + off, ih = hp + off, iw = w0 + (p - hp * Wv) + off;
    const bool in = unsigned(id) < unsigned(G1) && unsigned(ih) < unsigned(G2) &&
                    unsigned(iw) < unsigned(G3);
    rowoff[i] = in ? ((int64_t(b) * G1 + id) * G2 + ih) * int64_t(G3) * Lin + int64_t(iw) * Lin
                   : int64_t(-1);
  }
  __syncthreads();

  const int nstages = ring_stages(Lin);  // K1_NO_REUSE: stage s is chunk s / 8, tap s % 8
  auto tap_offset = [&](int tap) { return (tap >> 2) * HR + ((tap >> 1) & 1) * Wv + (tap & 1); };

  auto load_stage = [&](int slot, int s) {
    float* As = ring + slot * STAGE_FLOATS;
    float* Bs = As + 2 * A_FLOATS;
#ifdef K1_NO_REUSE
    const int k0 = (s >> 3) * BK;
    const int t0 = s & 7;
    const int r0 = tap_offset(t0);
    for (int i = tid; i < 2 * BM; i += NT) {
      const int r = r0 + (i >> 1), h = i & 1;
      const int64_t o = rowoff[r];
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(As + r * LDA + 4 * h)),
                 o >= 0 ? x + o + k0 + 4 * h : x, o >= 0);
    }
    {
      const int row = t0 * BK + (tid >> 5), c = tid & 31;
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(Bs + row * LDB + 4 * c)),
                 wf + (int64_t(t0) * Lin + k0 + (tid >> 5)) * Lout + n0 + 4 * c, true);
    }
#else
    const int k0 = s * BK;
    // the halo: 2 HR rows of 8 lanes, two 16-byte copies each
    for (int i = tid; i < 4 * HR; i += NT) {
      const int r = i >> 1, h = i & 1;
      const int64_t o = rowoff[r];
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(As + r * LDA + 4 * h)),
                 o >= 0 ? x + o + k0 + 4 * h : x, o >= 0);
    }
    // wf: row (tap, kk) = wf[tap, k0 + kk, n0 .. n0 + 128], 32 copies each
#pragma unroll
    for (int j = 0; j < 8 * BK * BN / 4 / NT; ++j) {
      const int i = tid + NT * j;
      const int row = i >> 5, c = i & 31;
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(Bs + row * LDB + 4 * c)),
                 wf + (int64_t(row >> 3) * Lin + k0 + (row & 7)) * Lout + n0 + 4 * c, true);
    }
#endif
  };

  // Compute role: warp (wm, wn) owns rows wm .. wm + BM / 2 and lanes
  // wn .. wn + 32 of the tile; lane (g, t4) holds the m16n8k8 fragments.
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const int wm = (warp & 1) * (BM / 2);
  const int wn = (warp >> 1) * 32;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // The halo values this thread copied into a stage, once they have landed:
  // each split once, hi over the value and lo into the same place of the lo
  // copy, so the fragment loads of all warps and taps read them split.
  auto split_stage = [&](int slot, int s) {
    float* As = ring + slot * STAGE_FLOATS;
    auto split4 = [&](int at) {
      const float4 v = *reinterpret_cast<const float4*>(As + at);
      uint4 hi, lo;
      split_tf32_rn(v.x, hi.x, lo.x);
      split_tf32_rn(v.y, hi.y, lo.y);
      split_tf32_rn(v.z, hi.z, lo.z);
      split_tf32_rn(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(As + at) = hi;
      *reinterpret_cast<uint4*>(As + A_FLOATS + at) = lo;
    };
#ifdef K1_NO_REUSE
    const int r0 = tap_offset(s & 7);
    for (int i = tid; i < 2 * BM; i += NT) split4((r0 + (i >> 1)) * LDA + 4 * (i & 1));
#else
    for (int i = tid; i < 4 * HR; i += NT) split4((i >> 1) * LDA + 4 * (i & 1));
#endif
  };

  // One tap of a stage: A rows (split) at the tap's offset, wf rows
  // tap * 8 .. + 8 (split here). The passes go into the stage's fresh sums
  // `d` (header: accumulation); K1_TAP_SUMS takes a fresh sum per tap and
  // 16 x 8 piece instead, K1_RUNNING_SUM none.
  auto mma_tap = [&](const float* As, const float* Bs, int tap, float (&d)[MT][4][4]) {
    const int o = tap_offset(tap);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* bp = Bs + (tap * BK + t4) * LDB + wn + 8 * j + g;
      split_tf32_rn(bp[0], bh[j][0], bl[j][0]);
      split_tf32_rn(bp[4 * LDB], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* ap = As + (wm + 16 * i + g + o) * LDA + t4;
      const float* lp = ap + A_FLOATS;
      const uint32_t ah[4] = {__float_as_uint(ap[0]), __float_as_uint(ap[8 * LDA]),
                              __float_as_uint(ap[4]), __float_as_uint(ap[8 * LDA + 4])};
      const uint32_t al[4] = {__float_as_uint(lp[0]), __float_as_uint(lp[8 * LDA]),
                              __float_as_uint(lp[4]), __float_as_uint(lp[8 * LDA + 4])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#if defined(K1_RUNNING_SUM)
        float (&c)[4] = acc[i][j];
#elif defined(K1_TAP_SUMS)
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#else
        float (&c)[4] = STAGE_SUMS ? d[i][j] : acc[i][j];
#endif
#ifndef K1_ONE_PASS
        mma_tf32(c, al, bh[j]);
        mma_tf32(c, ah, bl[j]);
#endif
        mma_tf32(c, ah, bh[j]);
#ifdef K1_TAP_SUMS
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[e];
#endif
      }
    }
  };

  // Taps t0 .. t1 of a stage.
  auto compute_taps = [&](const float* As, const float* Bs, int t0, int t1) {
    float d[MT][4][4];
#if !defined(K1_RUNNING_SUM) && !defined(K1_TAP_SUMS)
    if constexpr (STAGE_SUMS) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
    }
#endif
#pragma unroll
    for (int tap = t0; tap < t1; ++tap) mma_tap(As, Bs, tap, d);
#if !defined(K1_RUNNING_SUM) && !defined(K1_TAP_SUMS)
    if constexpr (STAGE_SUMS) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
    }
#endif
  };

  auto compute_stage = [&](int slot, int s) {
    const float* As = ring + slot * STAGE_FLOATS;
    const float* Bs = As + 2 * A_FLOATS;
#ifdef K1_NO_REUSE
    compute_taps(As, Bs, s & 7, (s & 7) + 1);
#else
    compute_taps(As, Bs, 0, 8);
#endif
  };

  // The ring: stage k waits for its own copies (at most STAGES - 2 younger
  // groups may be pending) and splits them, then a barrier, after which every
  // thread is done with stage k - 1, whose slot takes the copies of stage
  // k + STAGES - 1.
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

  // c0, c1 at (row g, lanes 2 t4, 2 t4 + 1); c2, c3 at row g + 8. Row m of
  // the tile is output voxel (qd, m / Wv, w0 + m % Wv); the padded column
  // (m % Wv == SW) and voxels past the grid are not written.
  const int64_t ybase = int64_t(bq) * Q2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + 16 * i + g + 8 * half;
      const int qh = m / Wv;
      const int c = m - qh * Wv;
      const int qw = w0 + c;
      if (qh >= Q2 || c >= SW || qw >= Q3) continue;
      float* yr = y + ((ybase + qh) * Q3 + qw) * Lout + n0 + wn + 2 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(yr + 8 * j) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
    }
  }
}

template <int STAGES, int MIN_BLOCKS, bool STAGE_SUMS>
cudaError_t launch_k1(const float* x, const float* wf, float* y, int B, int G1, int G2, int G3,
                      int Lin, int Lout, int Q1, int Q2, int Q3, int off, cudaStream_t st) {
  // a slot for each stage, at most STAGES; above the default 48 KB of
  // dynamic shared memory, set on every call, so every device the process
  // launches on gets it
  const int bytes = smem_bytes(ring_stages(Lin) < STAGES ? ring_stages(Lin) : STAGES);
  const cudaError_t err = cudaFuncSetAttribute(folded_conv3_kernel<STAGES, MIN_BLOCKS, STAGE_SUMS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nseg = (Q3 + SEG - 1) / SEG;
  const int SW = (Q3 + nseg - 1) / nseg;
  const int mtiles = (Q2 * (SW + 1) + BM - 1) / BM;
  const dim3 grid(nseg * mtiles, Lout / BN, B * Q1);
  folded_conv3_kernel<STAGES, MIN_BLOCKS, STAGE_SUMS><<<grid, NT, bytes, st>>>(
      x, wf, y, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, SW, mtiles);
  return cudaGetLastError();
}

}  // namespace

// x: (B, G1, G2, G3, Lin) float32, wf: (2, 2, 2, Lin, Lout) float32,
// y: (B, Q1, Q2, Q3, Lout) float32, all contiguous and 16-byte aligned;
// Lin % 8 == 0, Lout % 128 == 0 and B * Q1 <= 65535 (the wrapper checks).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dycon_folded_conv3_f32(const void* x, const void* wf, void* y, int B, int G1,
                                      int G2, int G3, int Lin, int Lout, int to_phase,
                                      void* stream) {
  const int step = to_phase == 1 ? 1 : -1;
  const int off = to_phase == 1 ? -1 : 0;
  const int Q1 = G1 + step, Q2 = G2 + step, Q3 = G3 + step;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wff = static_cast<const float*>(wf);
  float* yf = static_cast<float*>(y);
  const cudaError_t err =
      Lin == BK
          ? launch_k1<2, 2, false>(xf, wff, yf, B, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, st)
          : launch_k1<3, 1, true>(xf, wff, yf, B, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, st);
  return static_cast<int>(err);
}
