// K1-dW: the weight gradient of the fold-2 3^3 conv K1 (csrc/folded_conv3.cu),
// on Hopper's tensor cores: the float32 instance in three TF32 passes, the
// bfloat16 instance (K1-dW-bf16, at the end of this file) in one bf16 pass.
//
// Replaces: dycon_paper_replication_tpu/ops/folded_conv_pallas.py:179, `_dwf`,
// the weight half of the custom VJP `_conv_wf_bwd` that the JAX package runs
// as eight XLA slab einsums. Same function:
//
//   dwf[t, a, n] = sum_{b, q} x[b, q + off + t, a] * dy[b, q, n]
//
// for the 8 taps t in {0,1}^3, with off = -1 for to_phase = 1 (x at grid G,
// dy at G+1) and off = 0 for to_phase = 0 (x at G, dy at G-1). Reads outside
// the input grid count as zero; no shifted slab is materialised.
//
// What bounds it on an H100 SXM. As a GEMM it is dwf (M = 8 L_in rows
// r = tap * L_in + a, by N = L_out) = A^T dy over K = B*Q1*Q2*Q3 voxels,
// about 1.27 M at the Pancreas training shapes: FLOPs = 2 K M N. Each
// product is done three times on the TF32 tensor cores (below), so the
// operation bound is 3 x FLOPs over 495 TFLOP/s dense TF32; the byte bound
// is x and dy read once and dwf written once over 3.35 TB/s. The operation
// bound is the larger at every training shape but L_in = 8 (conv1.conv1,
// M = 64), which is bound by the bytes of dy.
//
// What the design does about it:
//   * Tensor cores, float32-exact. Each operand is split once per fragment
//     load into hi, v rounded to TF32 (to nearest, ties away: cvt.rna's
//     rounding, by two integer ops on the bits, faster than cvt), and
//     lo = v - hi (exact) truncated to TF32, which keeps a NaN or Inf in v
//     non-finite. Each 16x8x8 product accumulates lo_a*hi_b, then
//     hi_a*lo_b, then hi_a*hi_b (small terms first). What is dropped
//     (lo_a*lo_b, lo's last bits) is ~2^-21 of a product, so the result
//     sits at the float32 plain version's error, where one TF32 pass is
//     hundreds of times off (tests/test_torch_tf32.py emulates both on the
//     CPU).
//   * Accumulation. The tensor core does not round its float32 sums to
//     nearest: added into a running sum of ~10^2..10^3 over a split of
//     ~10^4 voxels, the error grows to ~200x the float32 plain version's
//     and fails the gate (conv1.conv2: 1.27 against 0.52; variant
//     `running` of scripts/k1_dw_variants.py). So each stage's products go
//     into a fresh sum (at most 32 voxels x 3 passes), which one float add
//     per element, rounded to nearest, takes into the running sum.
//   * mma.sync, not wgmma. Both operands arrive MN-major: an x row is
//     contiguous in a, a dy row in n, and the contraction runs over voxels.
//     wgmma takes TF32 only K-major from shared memory, so it would need a
//     transpose in staging; mma.sync.m16n8k8 reads its fragments with plain
//     shared loads and takes the tiles as they lie. Each shared row of
//     BM (or BN) floats is padded by 8 floats, so the lanes (g, t) of a
//     fragment load, at row t and column g, hit 32 different banks.
//   * An asynchronous ring. STAGES = 4 stages of BK = 32 voxels of
//     tap-shifted x rows and dy rows, copied by cp.async.cg 16 bytes at a
//     time into dynamic shared memory (136 KB at BM 128); a tap that falls
//     outside the grid, and a voxel past the split's end, take the
//     zero-fill form (source size 0). The copies of stage k + STAGES - 1 are
//     in flight while stage k computes.
//   * No division in the voxel walk. Each loader thread owns one voxel slot
//     of every stage and steps its (b, qd, qh, qw) by BK with carries; the
//     coordinates are divided out once, at the split's first voxel.
//   * Tiles. A block of 8 warps owns a BM x 128 tile of (rows, L_out), each
//     warp a (BM / 2) x 32 piece, with the running and the stage sums in
//     registers (213 at BM 128): one block per SM. BM is 128 where
//     L_in % 16 == 0 and 64 otherwise: L_in = 8 (conv1.conv1) makes 8 taps
//     x 8 lanes = 64 rows, exactly one tile with no masked rows.
//   * Deterministic split-K. The contraction (K ~ 10^6) dwarfs the output
//     (at most 6144 x 256), so the voxels are split over blocks; each block
//     writes its float32 partial tile to a workspace (splits x 8 L_in x
//     L_out) and a second kernel sums the partials in split order. No float
//     atomics, so reruns are bit-identical.
//
// K1-dW-bf16 (dycon_folded_conv3_dw_bf16) is the same function on bf16 x
// and dy, as the JAX package's custom VJP computes it under its bfloat16
// compute dtype: `_dwf` sums in float32 and `.astype(wf.dtype)` rounds the
// sum to bf16. The split-K and its workspace stay, and the split-sum kernel
// rounds to bf16 to nearest even. Its bound is FLOPs over 989 TFLOP/s dense
// bf16, or the bytes of dy at L_in = 8. Two instances, by L_in:
//   * L_in % 64 == 0 (every conv of both model families but the first):
//     wgmma, below.
//   * L_in = 8 (conv1.conv1, the VNet's enc0; any L_in % 64 != 0):
//     mma.sync. Bound by the bytes of dy and ahead of cuDNN's bf16 wgrad, it
//     is the float32 kernel's tiles, split, ring, stage sums and voxel walk
//     with one m16n8k16 bf16 mma.sync per product; ldmatrix.trans feeds both
//     MN-major tiles (x rows contiguous in a, dy rows in n) from rows padded
//     by 8 bf16.
//
// The wgmma instance replaces that design at L_in % 64 == 0, where it ran
// at 0.13-0.15 of its bound, 3x slower than cuDNN's wgrad: its staging by
// every thread, its barriers and its stage sums set the time. What bounds
// the redesign: the tensor cores' operations, and the bytes of dy, which
// every block reads from L2 (2 L_in / 64 blocks read each voxel's 128
// lanes). The design, K1-bf16's pattern:
//   * GEMM rows (tap, a) by L_out over the voxels. A block takes one
//     64-lane chunk of L_in and one d-tap td, so 4 taps x 64 rows, 128
//     output lanes, and one split of the voxel tiles; warpgroup w computes
//     taps (td, w, 0) and (td, w, 1), one m64 piece each. One thread of a
//     third warpgroup issues the TMA loads into a ring of 2-4 stages (full
//     and empty mbarriers); setmaxnreg as in K1-bf16.
//   * Voxel tiles of whole rows: `rows` rows of sw columns of one (b, qd)
//     plane of dy, about 256 voxels. Per tile, TMA loads x's halo box, 64
//     lanes x (sw + 1) x (rows + 1) x 1 d-plane from the tap-shifted corner
//     (zero-filled outside the grid), read by all 4 taps, and dy's two
//     64-lane boxes of sw x rows.
//   * A from registers by ldmatrix.trans: the tap-shifted x as a (lanes) x
//     voxels, each lane giving the halo row of its voxel, (vr + th)(sw + 1)
//     + vc + tw; a voxel outside dy's grid reads a zero row (dy is zero
//     there, x may hold a NaN that no dy multiplies). B, dy's N-contiguous
//     rows, by descriptor, MN-major; the tile's k16 tail reads zero rows.
//   * Accumulation: one running float32 sum over a split (at most 131,072
//     voxels, ops/folded_conv_cuda.py:DW_WG_MAX_CHUNK), no fresh sums; the
//     split sum adds the partials with rounded adds. tests/
//     test_torch_bf16_mma.py emulates wgmma's truncated sums over the split
//     at the Pancreas up_concat1.conv1 shape: within a quarter of the room
//     the gate leaves above one rounding.
//   * Deterministic split-K as before: no atomics, reruns bit-identical.
// Tried and slower (PERF.md): tiles of ~96-160 voxels on rings of 3-8
// stages; 2-CTA clusters (td = 0, 1) that multicast dy.

#include "tf32_mma.cuh"
#include "bf16_mma.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int BN = 128;     // output lanes per block
constexpr int BK = 32;      // voxels per stage
constexpr int STAGES = 4;   // depth of the shared-memory ring
constexpr int NT = 256;     // threads: 8 warps, 2 along the rows x 4 along the lanes
constexpr int PAD = 8;      // floats after each shared row
constexpr int LDB = BN + PAD;

template <int BM>
__host__ __device__ constexpr int stage_floats() {
  return BK * (BM + PAD) + BK * LDB;
}

template <int BM>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_floats<BM>() * 4;
}

template <int BM>
__global__ void __launch_bounds__(NT, 1)
folded_conv3_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       float* __restrict__ ws, int G1, int G2, int G3, int Lin, int Lout,
                       int Q1, int Q2, int Q3, int off, int V, int chunk) {
  constexpr int LDA = BM + PAD;
  constexpr int A_COPIES = BM / 32;  // 16-byte copies of x per thread per stage
  constexpr int B_COPIES = BN / 32;  // of dy
  constexpr int MT = BM / 32;        // 16-row tiles per warp
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int M = 8 * Lin;
  const int v_begin = split * chunk;
  const int v_end = min(V, v_begin + chunk);
  const int nstages = (v_end - v_begin + BK - 1) / BK;

  // Loader role: voxel slot kv of every stage; 16-byte column chunks
  // c + 8 i of its x rows (A) and of its dy row (B).
  const int kv = tid >> 3;
  const int c = tid & 7;
  // Per x chunk: the tap's bits (td << 2 | th << 1 | tw) and the element
  // offset of (tap, a) from the unshifted voxel, tap-shift * L_in + a.
  int tap[A_COPIES], xoff[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int r = r0 + 4 * (c + 8 * i);  // 4 rows in one tap: L_in % 8 == 0
    const int t = r / Lin;
    tap[i] = t;
    xoff[i] = (((t >> 2) * G2 + ((t >> 1) & 1)) * G3 + (t & 1)) * Lin + (r - t * Lin);
  }
  int v = v_begin + kv;
  int b = v / (Q1 * Q2 * Q3);
  int rem = v - b * (Q1 * Q2 * Q3);
  int qd = rem / (Q2 * Q3);
  rem -= qd * (Q2 * Q3);
  int qh = rem / Q3;
  int qw = rem - qh * Q3;

  auto load_stage = [&](int s) {
    float* As = smem + s * stage_floats<BM>();
    float* Bs = As + BK * LDA;
    const bool live = v < v_end;
    const uint32_t bdst = static_cast<uint32_t>(__cvta_generic_to_shared(Bs + kv * LDB + 4 * c));
    const float* bsrc = live ? dy + int64_t(v) * Lout + n0 + 4 * c : dy;
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) cp_async16(bdst + 128 * i, bsrc + (live ? 32 * i : 0), live);
    // bit s of md: x plane qd + off + s lies in the grid (likewise mh, mw)
    const int id = qd + off, ih = qh + off, iw = qw + off;
    const int md = (unsigned(id) < unsigned(G1)) | ((unsigned(id + 1) < unsigned(G1)) << 1);
    const int mh = (unsigned(ih) < unsigned(G2)) | ((unsigned(ih + 1) < unsigned(G2)) << 1);
    const int mw = (unsigned(iw) < unsigned(G3)) | ((unsigned(iw + 1) < unsigned(G3)) << 1);
    const int64_t base = (((int64_t(b) * G1 + id) * G2 + ih) * G3 + iw) * Lin;
    const uint32_t adst = static_cast<uint32_t>(__cvta_generic_to_shared(As + kv * LDA + 4 * c));
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int t = tap[i];
      const bool ok = live && ((md >> (t >> 2)) & (mh >> ((t >> 1) & 1)) & (mw >> (t & 1)) & 1);
      cp_async16(adst + 128 * i, ok ? x + base + xoff[i] : x, ok);
    }
    // the next stage's voxel of this slot: BK further on
    v += BK;
    qw += BK;
    while (qw >= Q3) {
      qw -= Q3;
      if (++qh == Q2) {
        qh = 0;
        if (++qd == Q1) {
          qd = 0;
          ++b;
        }
      }
    }
  };

  // Compute role: warp (wm, wn) owns rows wm .. wm + BM/2 and lanes
  // wn .. wn + 32 of the tile; lane (g, t) holds the m16n8k8 fragments.
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

  auto compute_stage = [&](int s) {
    const float* As = smem + s * stage_floats<BM>();
    const float* Bs = As + BK * LDA;
    // The stage's products go into a fresh sum, added into the running one
    // once per stage with a round-to-nearest float add (header: accumulation).
    float d[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bp = Bs + (kk + t4) * LDB + wn + 8 * j + g;
        split_tf32(bp[0], bh[j][0], bl[j][0]);
        split_tf32(bp[4 * LDB], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ap = As + (kk + t4) * LDA + wm + 16 * i + g;
        uint32_t ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8], ah[1], al[1]);
        split_tf32(ap[4 * LDA], ah[2], al[2]);
        split_tf32(ap[4 * LDA + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(d[i][j], al, bh[j]);
          mma_tf32(d[i][j], ah, bl[j]);
          mma_tf32(d[i][j], ah, bh[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
  };

  // The ring: stage k waits for its own copies (at most STAGES - 2 younger
  // groups may be pending), then a barrier, after which every thread is done
  // with stage k - 1, whose slot takes the copies of stage k + STAGES - 1.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) load_stage(s);
    cp_async_commit();
  }
  for (int k = 0; k < nstages; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = k + STAGES - 1;
    if (next < nstages) load_stage(next % STAGES);
    cp_async_commit();
    compute_stage(k % STAGES);
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, lanes 2 t, 2 t + 1); c2, c3 at row g + 8.
  float* part = ws + int64_t(split) * M * Lout;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = r0 + wm + 16 * i + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(part + int64_t(r) * Lout + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + int64_t(r + 8) * Lout + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// dwf = sum over splits of ws[split], in split order.
__global__ void sum_splits_kernel(const float4* __restrict__ ws, float4* __restrict__ dwf,
                                  int n4, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = ws[i];
  for (int k = 1; k < splits; ++k) {
    const float4 w = ws[int64_t(k) * n4 + i];
    s.x += w.x;
    s.y += w.y;
    s.z += w.z;
    s.w += w.w;
  }
  dwf[i] = s;
}

template <int BM>
cudaError_t launch_dw(const float* x, const float* dy, float* ws, int G1, int G2, int G3,
                      int Lin, int Lout, int Q1, int Q2, int Q3, int off, int V, int splits,
                      int chunk, cudaStream_t st) {
  // above the default 48 KB of dynamic shared memory; set on every call, so
  // every device the process launches on gets it
  const cudaError_t err = cudaFuncSetAttribute(
      folded_conv3_dw_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM>());
  if (err != cudaSuccess) return err;
  const dim3 grid(Lout / BN, 8 * Lin / BM, splits);
  folded_conv3_dw_kernel<BM><<<grid, NT, smem_bytes<BM>(), st>>>(
      x, dy, ws, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, V, chunk);
  return cudaGetLastError();
}

// ---- K1-dW-bf16 ----------------------------------------------------------

template <int BM>
__host__ __device__ constexpr int stage_elems_bf16() {
  return BK * (BM + PAD) + BK * LDB;
}

template <int BM>
__host__ __device__ constexpr int smem_bytes_bf16() {
  return STAGES * stage_elems_bf16<BM>() * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The float32 kernel's tiles, split, ring and voxel walk on bf16 operands;
// float32 partial tiles into the same workspace.
template <int BM>
__global__ void __launch_bounds__(NT, 1)
folded_conv3_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ dy, float* __restrict__ ws,
                            int G1, int G2, int G3, int Lin, int Lout, int Q1, int Q2, int Q3,
                            int off, int V, int chunk) {
  constexpr int LDA = BM + PAD;
  constexpr int A_COPIES = BM / 64;  // 16-byte copies (8 rows) of x per thread per stage
  constexpr int B_COPIES = BN / 64;  // (8 lanes) of dy
  constexpr int MT = BM / 32;        // 16-row tiles per warp
  extern __shared__ __align__(16) unsigned char smem_dw_bf16[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_dw_bf16);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int M = 8 * Lin;
  const int v_begin = split * chunk;
  const int v_end = min(V, v_begin + chunk);
  const int nstages = (v_end - v_begin + BK - 1) / BK;

  // Loader role: voxel slot kv of every stage; 16-byte chunks c + 8 i of
  // its x rows (A: rows r0 + 8 (c + 8 i) .. + 8, one tap) and of its dy row.
  const int kv = tid >> 3;
  const int c = tid & 7;
  int tap[A_COPIES], xoff[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int r = r0 + 8 * (c + 8 * i);
    const int t = r / Lin;
    tap[i] = t;
    xoff[i] = (((t >> 2) * G2 + ((t >> 1) & 1)) * G3 + (t & 1)) * Lin + (r - t * Lin);
  }
  int v = v_begin + kv;
  int b = v / (Q1 * Q2 * Q3);
  int rem = v - b * (Q1 * Q2 * Q3);
  int qd = rem / (Q2 * Q3);
  rem -= qd * (Q2 * Q3);
  int qh = rem / Q3;
  int qw = rem - qh * Q3;

  auto load_stage = [&](int s) {
    __nv_bfloat16* As = smem + s * stage_elems_bf16<BM>();
    __nv_bfloat16* Bs = As + BK * LDA;
    const bool live = v < v_end;
    const uint32_t bdst = smem_u32(Bs + kv * LDB + 8 * c);
    const __nv_bfloat16* bsrc = live ? dy + int64_t(v) * Lout + n0 + 8 * c : dy;
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) cp_async16(bdst + 128 * i, bsrc + (live ? 64 * i : 0), live);
    const int id = qd + off, ih = qh + off, iw = qw + off;
    const int md = (unsigned(id) < unsigned(G1)) | ((unsigned(id + 1) < unsigned(G1)) << 1);
    const int mh = (unsigned(ih) < unsigned(G2)) | ((unsigned(ih + 1) < unsigned(G2)) << 1);
    const int mw = (unsigned(iw) < unsigned(G3)) | ((unsigned(iw + 1) < unsigned(G3)) << 1);
    const int64_t base = (((int64_t(b) * G1 + id) * G2 + ih) * G3 + iw) * Lin;
    const uint32_t adst = smem_u32(As + kv * LDA + 8 * c);
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int t = tap[i];
      const bool ok = live && ((md >> (t >> 2)) & (mh >> ((t >> 1) & 1)) & (mw >> (t & 1)) & 1);
      cp_async16(adst + 128 * i, ok ? x + base + xoff[i] : x, ok);
    }
    v += BK;
    qw += BK;
    while (qw >= Q3) {
      qw -= Q3;
      if (++qh == Q2) {
        qh = 0;
        if (++qd == Q1) {
          qd = 0;
          ++b;
        }
      }
    }
  };

  // warp (wm, wn) owns rows wm .. wm + BM/2 and lanes wn .. wn + 32; for
  // ldmatrix, lane (lm, lr) = (lane / 8, lane % 8) gives row lr of matrix lm
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const int wm = (warp & 1) * (BM / 2);
  const int wn = (warp >> 1) * 32;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Per k16 step: B matrices (voxels kk.. | kk + 8..) x (piece 2 jj |
  // 2 jj + 1); A matrices (rows 0-7 | 8-15) x (voxels kk.. | kk + 8..), both
  // transposed out of their voxel-major rows.
  auto compute_stage = [&](int s) {
    const __nv_bfloat16* As = smem + s * stage_elems_bf16<BM>();
    const __nv_bfloat16* Bs = As + BK * LDA;
    float d[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4_trans(r, smem_u32(Bs + (kk + 8 * (lm & 1) + lr) * LDB + wn +
                                  8 * (2 * jj + (lm >> 1))));
        bfr[2 * jj][0] = r[0];
        bfr[2 * jj][1] = r[1];
        bfr[2 * jj + 1][0] = r[2];
        bfr[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldsm_x4_trans(a, smem_u32(As + (kk + 8 * (lm >> 1) + lr) * LDA + wm + 16 * i +
                                  8 * (lm & 1)));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(d[i][j], a, bfr[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) load_stage(s);
    cp_async_commit();
  }
  for (int k = 0; k < nstages; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = k + STAGES - 1;
    if (next < nstages) load_stage(next % STAGES);
    cp_async_commit();
    compute_stage(k % STAGES);
  }
  cp_async_wait<0>();

  float* part = ws + int64_t(split) * M * Lout;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = r0 + wm + 16 * i + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(part + int64_t(r) * Lout + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + int64_t(r + 8) * Lout + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// dwf = the sum over splits of ws[split], in split order, rounded to bf16
// to nearest even.
__global__ void sum_splits_bf16_kernel(const float4* __restrict__ ws,
                                       __nv_bfloat162* __restrict__ dwf, int n4, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = ws[i];
  for (int k = 1; k < splits; ++k) {
    const float4 w = ws[int64_t(k) * n4 + i];
    s.x += w.x;
    s.y += w.y;
    s.z += w.z;
    s.w += w.w;
  }
  dwf[2 * i] = pack_bf16_rn(s.x, s.y);
  dwf[2 * i + 1] = pack_bf16_rn(s.z, s.w);
}

template <int BM>
cudaError_t launch_dw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* ws, int G1,
                           int G2, int G3, int Lin, int Lout, int Q1, int Q2, int Q3, int off,
                           int V, int splits, int chunk, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(folded_conv3_dw_bf16_kernel<BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes_bf16<BM>());
  if (err != cudaSuccess) return err;
  const dim3 grid(Lout / BN, 8 * Lin / BM, splits);
  folded_conv3_dw_bf16_kernel<BM><<<grid, NT, smem_bytes_bf16<BM>(), st>>>(
      x, dy, ws, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, V, chunk);
  return cudaGetLastError();
}

// ---- K1-dW-bf16 on wgmma (L_in % 64 == 0) ---------------------------------

constexpr int WG_THREADS = 384;  // 2 consumer warpgroups, then the producer's
constexpr int WG_LANES = 64;     // input lanes per x box: one 128-byte row

// Stage layout: the x halo (xrows 128-byte rows: the box's (rows + 1) x
// (sw + 1) voxels, then zero rows), then dy's two 64-lane halves of kpad
// rows each (the box's rows x sw voxels, then zero rows).
__host__ __device__ inline int wgmma_stage_bytes(int xrows, int kpad) {
  return (xrows + 2 * kpad) * 128;
}

// Block (kc, td) x n-tile x split: rows (tap, a) of the taps (td, th, tw)
// for one 64-lane chunk kc of L_in, 128 output lanes, over the split's
// voxel tiles. Warpgroup w computes taps (td, w, 0) and (td, w, 1), one
// m64 piece each; one thread of warpgroup 2 issues the TMA loads.
__global__ void __launch_bounds__(WG_THREADS, 1)
folded_conv3_dw_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                                  const __grid_constant__ CUtensorMap tmap_dy,
                                  float* __restrict__ ws, int Lin, int Lout, int Q1, int Q2,
                                  int Q3, int off, int sw, int rows, int htiles, int nseg,
                                  int xrows, int kpad, int slots, int ntiles, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = wgmma_stage_bytes(xrows, kpad);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + slots * stage_bytes);
  uint64_t* empty = full + slots;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wh = sw + 1;
  const int kc = blockIdx.x >> 1;
  const int td = blockIdx.x & 1;
  const int n0 = blockIdx.y * 128;
  const int split = blockIdx.z;
  const int t_begin = split * chunk;
  const int t_end = min(ntiles, t_begin + chunk);
  const int nvox = rows * sw;  // the dy box's voxels

  // zero rows: the x halo's past its box, dy's past its box (never written
  // by TMA), so a masked voxel reads x = 0 and the k16 tail reads dy = 0
  for (int sl = 0; sl < slots; ++sl) {
    unsigned char* base = smem + sl * stage_bytes;
    for (int i = (rows + 1) * wh * 8 + tid; i < xrows * 8; i += WG_THREADS)
      reinterpret_cast<uint4*>(base)[i] = make_uint4(0, 0, 0, 0);
    for (int h = 0; h < 2; ++h) {
      uint4* d = reinterpret_cast<uint4*>(base + (xrows + h * kpad) * 128);
      for (int i = nvox * 8 + tid; i < kpad * 8; i += WG_THREADS) d[i] = make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async();
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // voxel tile t: (b, qd, row tile, segment), in that order of significance
  auto decode = [&](int t, int& b, int& qd, int& h0, int& w0) {
    const int seg = t % nseg;
    t /= nseg;
    const int ht = t % htiles;
    t /= htiles;
    qd = t % Q1;
    b = t / Q1;
    h0 = ht * rows;
    w0 = seg * sw;
  };

  if (warp >= 8) {
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      tma_prefetch_map(&tmap_x);
      tma_prefetch_map(&tmap_dy);
      const uint32_t bytes = uint32_t((rows + 1) * wh + 2 * nvox) * 128;
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % slots;
        int b, qd, h0, w0;
        decode(t, b, qd, h0, w0);
        mbar_wait(&empty[s], ((i / slots) & 1) ^ 1);
        mbar_arrive_tx(&full[s], bytes);
        unsigned char* base = smem + s * stage_bytes;
        tma_load_5d(base, &tmap_x, &full[s], kc * WG_LANES, w0 + off, h0 + off, qd + off + td,
                    b);
        tma_load_5d(base + xrows * 128, &tmap_dy, &full[s], n0, w0, h0, qd, b);
        tma_load_5d(base + (xrows + kpad) * 128, &tmap_dy, &full[s], n0 + 64, w0, h0, qd, b);
      }
    }
  } else {
    regs_alloc<232>();
    const int wg = warp >> 2;
    const int wi = warp & 3;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int lm = lane >> 3;
    // ldmatrix.trans: this lane gives the row of voxel vk of a k16 step in
    // matrix lm = (lanes 0-7 | 8-15 of the warp's 16) x (voxels 0-7 | 8-15)
    const int vk = 8 * (lm >> 1) + (lane & 7);
    const int achunk = 2 * wi + (lm & 1);
    const int zrow = (rows + 1) * wh;  // a zero row of the halo
    const int o0 = wg * wh;            // tap (td, wg, 0); (td, wg, 1) is one row on
    const int vr0 = vk / sw, vc0 = vk - (vk / sw) * sw;
    float acc[2][64];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[j][e] = 0.f;

    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin, s = i % slots;
      int b, qd, h0, w0;
      decode(t, b, qd, h0, w0);
      const int rmax = min(rows, Q2 - h0), cmax = min(sw, Q3 - w0);
      mbar_wait(&full[s], (i / slots) & 1);
      const uint32_t xs = smem_addr(smem + s * stage_bytes);
      const uint32_t dys = xs + xrows * 128;
      int vr = vr0, vc = vc0;  // this lane's voxel (row, column) in the tile
      for (int kk = 0; kk < kpad; kk += 16) {
        const bool valid = vr < rmax && vc < cmax;
        const int r = vr * wh + vc + o0;
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int rj = valid ? r + j : zrow;
          ldsm_x4_trans(a[j], xs + rj * 128 + ((achunk ^ (rj & 7)) << 4));
        }
        const uint64_t desc = desc_mn_sw128(dys + kk * 128, kpad * 128, 1024);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
        wgmma_m64n128k16_rs(acc[0], a[0], desc);
        wgmma_m64n128k16_rs(acc[1], a[1], desc);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        // every wgmma of the previous tile is done: its slot is free
        if (kk == 0 && i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % slots]);
        vc += 16;
        while (vc >= sw) {
          vc -= sw;
          ++vr;
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);

    // acc[j]: rows a = 16 wi + g (+ 8) of tap (td, wg, j), columns 8 q + 2 t4
    float* part = ws + int64_t(split) * 8 * Lin * Lout;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tap = 4 * td + 2 * wg + j;
      const int r = tap * Lin + kc * WG_LANES + 16 * wi + g;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int n = n0 + 8 * q + 2 * t4;
        *reinterpret_cast<float2*>(part + int64_t(r) * Lout + n) =
            make_float2(acc[j][4 * q], acc[j][4 * q + 1]);
        *reinterpret_cast<float2*>(part + int64_t(r + 8) * Lout + n) =
            make_float2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
    }
  }
}

cudaError_t launch_dw_bf16_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* ws,
                                 int B, int G1, int G2, int G3, int Lin, int Lout, int Q1, int Q2,
                                 int Q3, int off, int splits, int chunk, int sw, int rows,
                                 int slots, cudaStream_t st) {
  const int wh = sw + 1;
  const int kpad = (rows * sw + 15) / 16 * 16;
  const int xrows = ((rows + 1) * wh + 1 + 7) / 8 * 8;  // at least one zero row, 1024-aligned
  if (Lin % WG_LANES || Lout % 128 || sw < 1 || rows < 1 || slots < 2)
    return cudaErrorInvalidValue;
  // x as (L_in, G3, G2, G1, B), a box = 64 lanes x (sw + 1) x (rows + 1) x
  // 1 d-plane from the tile's tap-shifted corner; dy as (L_out, Q3, Q2, Q1,
  // B), a box = 64 lanes x sw x rows
  CUtensorMap tmap_x, tmap_dy;
  const uint64_t xd[5] = {uint64_t(Lin), uint64_t(G3), uint64_t(G2), uint64_t(G1), uint64_t(B)};
  const uint64_t xs[4] = {uint64_t(Lin) * 2, uint64_t(G3) * Lin * 2,
                          uint64_t(G2) * G3 * Lin * 2, uint64_t(G1) * G2 * G3 * Lin * 2};
  const uint32_t xb[5] = {WG_LANES, uint32_t(wh), uint32_t(rows + 1), 1, 1};
  const uint64_t dd[5] = {uint64_t(Lout), uint64_t(Q3), uint64_t(Q2), uint64_t(Q1), uint64_t(B)};
  const uint64_t ds[4] = {uint64_t(Lout) * 2, uint64_t(Q3) * Lout * 2,
                          uint64_t(Q2) * Q3 * Lout * 2, uint64_t(Q1) * Q2 * Q3 * Lout * 2};
  const uint32_t db[5] = {64, uint32_t(sw), uint32_t(rows), 1, 1};
  if (!encode_bf16_map(&tmap_x, x, 5, xd, xs, xb) || !encode_bf16_map(&tmap_dy, dy, 5, dd, ds, db))
    return cudaErrorInvalidValue;
  const int bytes = 1024 + slots * wgmma_stage_bytes(xrows, kpad) + 16 * slots;
  const cudaError_t err = cudaFuncSetAttribute(
      folded_conv3_dw_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nseg = (Q3 + sw - 1) / sw;
  const int htiles = (Q2 + rows - 1) / rows;
  const int ntiles = B * Q1 * htiles * nseg;
  if (int64_t(splits) * chunk < ntiles || int64_t(splits - 1) * chunk >= ntiles)
    return cudaErrorInvalidValue;
  const dim3 grid(2 * (Lin / WG_LANES), Lout / 128, splits);
  folded_conv3_dw_bf16_wgmma_kernel<<<grid, WG_THREADS, bytes, st>>>(
      tmap_x, tmap_dy, ws, Lin, Lout, Q1, Q2, Q3, off, sw, rows, htiles, nseg, xrows, kpad, slots,
      ntiles, chunk);
  return cudaGetLastError();
}

}  // namespace

// x: (B, G1, G2, G3, Lin), dy: (B, Q1, Q2, Q3, Lout) with Q = G + 1
// (to_phase 1) or G - 1 (to_phase 0), ws: (splits, 8 Lin, Lout) scratch,
// dwf: (2, 2, 2, Lin, Lout); float32, contiguous, 16-byte aligned;
// Lin % 8 == 0, Lout % 128 == 0, B*Q1*Q2*Q3 < 2^31, `chunk` voxels per split
// and splits * chunk covering them (the wrapper checks; a chunk that is a
// multiple of 32 leaves no partial stage). Row tiles are 128 rows where
// Lin % 16 == 0, else 64. Launches both kernels on `stream` and returns
// cudaGetLastError().
extern "C" int dycon_folded_conv3_dw_f32(const void* x, const void* dy, void* ws, void* dwf,
                                         int B, int G1, int G2, int G3, int Lin, int Lout,
                                         int to_phase, int splits, int chunk, void* stream) {
  const int step = to_phase == 1 ? 1 : -1;
  const int off = to_phase == 1 ? -1 : 0;
  const int Q1 = G1 + step, Q2 = G2 + step, Q3 = G3 + step;
  const int V = B * Q1 * Q2 * Q3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  float* wsf = static_cast<float*>(ws);
  const cudaError_t err =
      Lin % 16 == 0
          ? launch_dw<128>(xf, dyf, wsf, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, V, splits, chunk, st)
          : launch_dw<64>(xf, dyf, wsf, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, V, splits, chunk, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = 8 * Lin * Lout / 4;
  sum_splits_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(static_cast<const float4*>(ws),
                                                      static_cast<float4*>(dwf), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

// The same function and contract on bf16 x and dy and a bf16 dwf (K1-dW-bf16);
// ws stays float32. With sw > 0 (L_in % 64 == 0) the wgmma instance, on the
// wrapper's plan (ops/folded_conv_cuda.py:dw_bf16_plan): voxel tiles of
// `rows` rows of sw columns of one (b, qd) plane of dy, `chunk` tiles per
// split, a ring of `slots` stages; the tensor maps are encoded here, on
// every call. With sw == 0 the mma.sync instance (L_in = 8, or any L_in %
// 64 != 0), `chunk` voxels per split.
extern "C" int dycon_folded_conv3_dw_bf16(const void* x, const void* dy, void* ws, void* dwf,
                                          int B, int G1, int G2, int G3, int Lin, int Lout,
                                          int to_phase, int splits, int chunk, int sw, int rows,
                                          int slots, void* stream) {
  const int step = to_phase == 1 ? 1 : -1;
  const int off = to_phase == 1 ? -1 : 0;
  const int Q1 = G1 + step, Q2 = G2 + step, Q3 = G3 + step;
  const int V = B * Q1 * Q2 * Q3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  float* wsf = static_cast<float*>(ws);
  const cudaError_t err =
      sw > 0 ? launch_dw_bf16_wgmma(xb, dyb, wsf, B, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off,
                                    splits, chunk, sw, rows, slots, st)
      : Lin % 16 == 0
          ? launch_dw_bf16<128>(xb, dyb, wsf, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, V, splits,
                                chunk, st)
          : launch_dw_bf16<64>(xb, dyb, wsf, G1, G2, G3, Lin, Lout, Q1, Q2, Q3, off, V, splits,
                               chunk, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = 8 * Lin * Lout / 4;
  sum_splits_bf16_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(static_cast<const float4*>(ws),
                                                           static_cast<__nv_bfloat162*>(dwf), n4,
                                                           splits);
  return static_cast<int>(cudaGetLastError());
}
