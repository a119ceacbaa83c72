// K1: the fold-2 3^3 SAME conv as a dense 2^3-tap conv over the folded grid.
//
// Replaces: dycon_paper_replication_tpu/ops/folded_conv_pallas.py,
// folded_conv3_pallas (body _kernel), the TPU kernel that the JAX package
// reaches through ops/folding.py:folded_conv3. Same function, without bias:
//
//   y[b, q, n] = sum_{t in {0,1}^3} sum_k x[b, q + t + off, k] * wf[t, k, n]
//
// with off = -1 for to_phase = 1 (grid G -> G+1, pad (1,1)) and off = 0 for
// to_phase = 0 (grid G -> G-1, VALID). Reads outside the input grid count as
// zero; the pad is never materialised.
//
// What bounds it on an H100: the work is an implicit GEMM with
// M = B*Q1*Q2*Q3 output voxels, N = L_out and K = 8*L_in, so
// FLOPs = 2*B*Q1*Q2*Q3*L_in*L_out*8. Every input row is reused by the 8 taps
// and all L_out columns; at the UNet's shapes (L_in 8..768, L_out 128/256)
// the arithmetic intensity is 30..400 FLOP per byte of x+wf+y, so at float32
// on the CUDA cores (67 TFLOP/s, 3.35 TB/s, a ridge at 20 FLOP/byte) all
// eight shapes are bound by operations, the L_in = 8 conv closest to the line.
//
// What the design does about it: a classic register-tiled SGEMM.
//   * One block owns 128 output voxels of one (b, qd) plane and 128 output
//     lanes. It walks the 8 taps x (L_in / 8) lane chunks as one K loop.
//   * Each chunk stages a 128 x 8 input tile (gathered per voxel from the
//     tap-shifted coordinate, zero outside the grid) and an 8 x 128 tap
//     slice in shared memory, double-buffered, with the next chunk's global
//     loads issued before the current chunk's FMAs.
//   * Each of the 256 threads keeps an 8 x 8 float32 accumulator in
//     registers and reads its operands as float4 from shared memory
//     (4 LDS.128 per 64 FMA).
// Plain float32 FMA, no TF32: the port's float32 path is held to the plain
// F.conv3d with TF32 off. Tensor cores (mma.sync / wgmma), TMA and bf16 are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output voxels of one (b, qd) plane per block
constexpr int BN = 128;  // output lanes per block
constexpr int BK = 8;    // input lanes per K chunk
constexpr int NT = 256;  // threads per block

__global__ void __launch_bounds__(NT)
folded_conv3_kernel(const float* __restrict__ x, const float* __restrict__ wf,
                    float* __restrict__ y, int G1, int G2, int G3, int Lin, int Lout,
                    int Q1, int Q2, int Q3, int off) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int plane = Q2 * Q3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int bq = blockIdx.z;  // b * Q1 + qd
  const int b = bq / Q1;
  const int qd = bq - b * Q1;

  // A loader: voxel ar of the tile, lanes akq..akq+3 of the chunk.
  const int ar = tid >> 1;
  const int akq = (tid & 1) * 4;
  const int ap = m0 + ar;
  const bool arow = ap < plane;
  const int aoh = arow ? ap / Q3 : 0;
  const int aow = arow ? ap - (ap / Q3) * Q3 : 0;
  // B loader: tap-slice row bk, lanes bn..bn+3.
  const int bk = tid >> 5;
  const int bn = (tid & 31) * 4;

  const int nk = Lin / BK;
  const int nchunks = 8 * nk;

  float4 av, bv;
  auto load = [&](int c) {
    const int tap = c / nk;
    const int k0 = (c - tap * nk) * BK;
    const int id = qd + (tap >> 2) + off;
    const int ih = aoh + ((tap >> 1) & 1) + off;
    const int iw = aow + (tap & 1) + off;
    av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (arow && id >= 0 && id < G1 && ih >= 0 && ih < G2 && iw >= 0 && iw < G3) {
      const int64_t v = ((int64_t(b) * G1 + id) * G2 + ih) * G3 + iw;
      av = *reinterpret_cast<const float4*>(x + v * Lin + k0 + akq);
    }
    bv = *reinterpret_cast<const float4*>(wf + (int64_t(tap) * Lin + k0 + bk) * Lout + n0 + bn);
  };
  auto store = [&](int s) {
    As[s][akq + 0][ar] = av.x;
    As[s][akq + 1][ar] = av.y;
    As[s][akq + 2][ar] = av.z;
    As[s][akq + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&Bs[s][bk][bn]) = bv;
  };

  // Thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
  // {tx*4 + j, 64 + tx*4 + j}: float4 reads of a warp cover 256 contiguous
  // bytes of Bs and hit each bank once per quarter warp.
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1;
    const bool more = c + 1 < nchunks;
    if (more) load(c + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    // Buffer s^1 was last read in iteration c-1, which ended in a barrier.
    if (more) store(s ^ 1);
    __syncthreads();
  }

  const int64_t ybase = int64_t(bq) * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const int p = m0 + r;
    if (p < plane) {
      float* yr = y + (ybase + p) * Lout + n0;
      *reinterpret_cast<float4*>(yr + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(yr + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

}  // namespace

// x: (B, G1, G2, G3, Lin) float32, wf: (2, 2, 2, Lin, Lout) float32,
// y: (B, Q1, Q2, Q3, Lout) float32, all contiguous and 16-byte aligned;
// Lin % 8 == 0 and Lout % 128 == 0 (the wrapper checks). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dycon_folded_conv3_f32(const void* x, const void* wf, void* y, int B, int G1,
                                      int G2, int G3, int Lin, int Lout, int to_phase,
                                      void* stream) {
  const int step = to_phase == 1 ? 1 : -1;
  const int off = to_phase == 1 ? -1 : 0;
  const int Q1 = G1 + step, Q2 = G2 + step, Q3 = G3 + step;
  const dim3 grid((Q2 * Q3 + BM - 1) / BM, Lout / BN, B * Q1);
  folded_conv3_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wf), static_cast<float*>(y), G1, G2,
      G3, Lin, Lout, Q1, Q2, Q3, off);
  return static_cast<int>(cudaGetLastError());
}
