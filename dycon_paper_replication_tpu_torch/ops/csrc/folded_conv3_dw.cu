// K1-dW: the weight gradient of the fold-2 3^3 conv K1 (csrc/folded_conv3.cu).
//
// Replaces: dycon_paper_replication_tpu/ops/folded_conv_pallas.py, `_dwf`, the
// weight half of the custom VJP `_conv_wf_bwd` that the JAX package runs as
// eight XLA slab einsums. Same function:
//
//   dwf[t, a, n] = sum_{b, q} x[b, q + off + t, a] * dy[b, q, n]
//
// for the 8 taps t in {0,1}^3, with off = -1 for to_phase = 1 (x at grid G,
// dy at G+1) and off = 0 for to_phase = 0 (x at G, dy at G-1). Reads outside
// the input grid count as zero; no shifted slab is materialised.
//
// What bounds it on an H100: seen as a GEMM, dwf (8 L_in x L_out rows and
// columns) = A^T dy with a contraction over K = B*Q1*Q2*Q3 voxels, about
// 1.27 M at the Pancreas training shapes, against an output of only
// 8 L_in x L_out. FLOPs = 2*K*L_in*L_out*8; every byte of x and dy is reused
// 8*L_out and 8*L_in times, so at float32 on the CUDA cores (67 TFLOP/s,
// 3.35 TB/s) all eight training shapes are bound by operations.
//
// What the design does about it: split-K over the voxels, then a
// deterministic reduction.
//   * Rows of the result are r = tap * L_in + a, across taps. A block owns a
//     128 x 128 tile of (rows, L_out) over one chunk of voxels. With
//     L_in = 8 (the first conv) the 8 taps x 8 lanes are the first 64 rows
//     of one tile and the other 64 rows are masked: one code path for every
//     shape, at the price of 2x work on the smallest conv (1.5 % of the dW
//     FLOPs of one step).
//   * Each stage gathers 8 voxels x 128 rows of tap-shifted x (a float4 per
//     thread, zero outside the grid) and 8 voxels x 128 lanes of dy into
//     shared memory, double-buffered, the next stage's global loads issued
//     before the current stage's FMAs. Each thread keeps an 8 x 8 float32
//     accumulator in registers (K1's register tiling).
//   * Each block writes its float32 partial tile to a workspace
//     (splits x 8 L_in x L_out); a second kernel sums the partials in split
//     order. No float atomics, so reruns are bit-identical.
// Plain float32 FMA, no TF32 and no tensor cores: the port's float32 path is
// held to a float32 reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // result rows (tap, a) per block
constexpr int BN = 128;  // output lanes per block
constexpr int BK = 8;    // voxels per stage
constexpr int NT = 256;  // threads per block

__global__ void __launch_bounds__(NT)
folded_conv3_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       float* __restrict__ ws, int G1, int G2, int G3, int Lin, int Lout,
                       int Q1, int Q2, int Q3, int off, int V, int chunk) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int M = 8 * Lin;
  const int v_begin = split * chunk;
  const int v_end = min(V, v_begin + chunk);
  const int plane = Q2 * Q3;
  const int vol = Q1 * plane;

  // Loader role: voxel kv of the stage, 4 consecutive rows (A) and lanes (B).
  const int kv = tid >> 5;
  const int c4 = (tid & 31) * 4;
  // The 4 rows ar..ar+3 lie in one tap, since L_in % 8 == 0.
  const int ar = r0 + c4;
  const bool arow = ar < M;
  const int tap = arow ? ar / Lin : 0;
  const int a = ar - tap * Lin;
  const int td = (tap >> 2) + off, th = ((tap >> 1) & 1) + off, tw = (tap & 1) + off;

  float4 av, bv;
  auto load = [&](int v0) {
    const int v = v0 + kv;
    av = make_float4(0.f, 0.f, 0.f, 0.f);
    bv = av;
    if (v < v_end) {
      bv = *reinterpret_cast<const float4*>(dy + int64_t(v) * Lout + n0 + c4);
      if (arow) {
        const int b = v / vol;
        int rem = v - b * vol;
        const int qd = rem / plane;
        rem -= qd * plane;
        const int qh = rem / Q3;
        const int qw = rem - qh * Q3;
        const int id = qd + td, ih = qh + th, iw = qw + tw;
        if (id >= 0 && id < G1 && ih >= 0 && ih < G2 && iw >= 0 && iw < G3) {
          const int64_t xi = ((int64_t(b) * G1 + id) * G2 + ih) * G3 + iw;
          av = *reinterpret_cast<const float4*>(x + xi * Lin + a);
        }
      }
    }
  };
  auto store = [&](int s) {
    *reinterpret_cast<float4*>(&As[s][kv][c4]) = av;
    *reinterpret_cast<float4*>(&Bs[s][kv][c4]) = bv;
  };

  // Thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and lanes
  // {tx*4 + j, 64 + tx*4 + j} of the tile, as in K1.
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nstages = (v_end - v_begin + BK - 1) / BK;
  load(v_begin);
  store(0);
  __syncthreads();
  for (int c = 0; c < nstages; ++c) {
    const int s = c & 1;
    const bool more = c + 1 < nstages;
    if (more) load(v_begin + (c + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    // Buffer s^1 was last read in iteration c-1, which ended in a barrier.
    if (more) store(s ^ 1);
    __syncthreads();
  }

  float* part = ws + int64_t(split) * M * Lout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r < M) {
      float* pr = part + int64_t(r) * Lout + n0;
      *reinterpret_cast<float4*>(pr + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(pr + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
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

}  // namespace

// x: (B, G1, G2, G3, Lin), dy: (B, Q1, Q2, Q3, Lout) with Q = G + 1
// (to_phase 1) or G - 1 (to_phase 0), ws: (splits, 8 Lin, Lout) scratch,
// dwf: (2, 2, 2, Lin, Lout); float32, contiguous, 16-byte aligned;
// Lin % 8 == 0, Lout % 128 == 0, B*Q1*Q2*Q3 < 2^31, `chunk` voxels per split
// (a multiple of 8) and splits * chunk covering them (the wrapper checks).
// Launches both kernels on `stream` and returns cudaGetLastError().
extern "C" int dycon_folded_conv3_dw_f32(const void* x, const void* dy, void* ws, void* dwf,
                                         int B, int G1, int G2, int G3, int Lin, int Lout,
                                         int to_phase, int splits, int chunk, void* stream) {
  const int step = to_phase == 1 ? 1 : -1;
  const int off = to_phase == 1 ? -1 : 0;
  const int Q1 = G1 + step, Q2 = G2 + step, Q3 = G3 + step;
  const int V = B * Q1 * Q2 * Q3;
  const int M = 8 * Lin;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Lout / BN, (M + BM - 1) / BM, splits);
  folded_conv3_dw_kernel<<<grid, NT, 0, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(dy),
                                               static_cast<float*>(ws), G1, G2, G3, Lin, Lout,
                                               Q1, Q2, Q3, off, V, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = M * Lout / 4;
  sum_splits_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(static_cast<const float4*>(ws),
                                                      static_cast<float4*>(dwf), n4, splits);
  return static_cast<int>(cudaGetLastError());
}
