#!/usr/bin/env python3
"""The rate of TF32 mma.sync.m16n8k8 on one GPU, as a ceiling for kernels
built on it (K1-dW, ops/csrc/folded_conv3_dw.cu).

    python3 scripts/mma_tf32_peak.py

A kernel of 8 warps per block runs a loop of 16 independent TF32
m16n8k8 products per warp on operands held in registers (no memory
traffic), launched with 1, 2 and 4 blocks per SM. Prints, per launch, the
TFLOP/s (2 x 16 x 8 x 8 per product) by CUDA events, then the card's name
and power limit. The source is built with nvcc into the port's build
directory.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed * (threadIdx.x + 7 * i) + 0x3f800000u) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed * (threadIdx.x + 5 * i) + 0x3f000000u) & 0xffffe000u;
  float c[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_loop(void* out, int blocks, int iters, void* stream) {
  mma_loop<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out),
                                                                  iters, 2654435761u);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    from dycon_paper_replication_tpu_torch.ops import _build

    src = _build.BUILD_DIR / "mma_tf32_peak.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    fn = _build.function(Path(src), "mma_tf32_loop",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for per_sm in (1, 2, 4):
        blocks = per_sm * sms
        out = torch.empty(blocks * 256, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(out.data_ptr(), blocks, iters, stream)
        if err:
            raise RuntimeError(f"launch failed, cudaError {err}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn(out.data_ptr(), blocks, iters, stream)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        flops = blocks * 8 * iters * 16 * 2 * 16 * 8 * 8
        print(f"{per_sm} block(s) of 8 warps per SM: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
              f"TF32 mma.sync", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
