#!/usr/bin/env python3
"""K1-dW's design choices, re-measured: variants of
`ops/csrc/folded_conv3_dw.cu` and its helper header `ops/csrc/tf32_mma.cuh`
made by text edits, built with nvcc, and timed and checked at the 8 convs
of one Pancreas training step on one GPU.

    python3 scripts/k1_dw_variants.py [--reps 10] [--out DIR]

Variants (each edit must apply exactly once, or the script stops):
  as-is     the source;
  cvt       hi and lo by cvt.rna.tf32.f32 (lo rounded, not truncated);
  running   every product straight into the running float32 sum, without
            the per-stage fresh sum;
  one-pass  hi_a*hi_b only: one TF32 pass (a diagnostic: the data path's
            share of the time);
  no-split  the raw float32 bits as hi and lo: three passes without the
            split's arithmetic (a diagnostic: its cost; wrong results);
  2-blocks  __launch_bounds__(256, 2) and a 3-stage ring: two blocks per
            SM under a 128-register cap (the wrapper's splits follow).
Per variant and shape one JSON line: ms (CUDA events over --reps launches
after a warm-up), TFLOP/s, the max error against a float64 dW and the
smoke's gate max(1e-4 max|ref|, 4 x the float32 plain version's error),
and whether a rerun is bit-identical; then each variant's sum, and the
card's name and power limit. Variants run in turn, the whole set twice.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MMA_STAGE_SUM = ("          mma_tf32(d[i][j], al, bh[j]);\n"
                 "          mma_tf32(d[i][j], ah, bl[j]);\n"
                 "          mma_tf32(d[i][j], ah, bh[j]);\n")
SPLIT = re.compile(r"__device__ __forceinline__ void split_tf32\(float v, uint32_t& hi, "
                   r"uint32_t& lo\) \{.*?\n\}", re.S)
CVT = ("__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {\n"
       "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(v));\n"
       "  const float rest = v - __uint_as_float(hi);\n"
       "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo) : \"f\"(rest));\n}")
RAW = ("__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {\n"
       "  hi = __float_as_uint(v);\n  lo = hi;\n}")


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"variant edit does not apply once: {old[:60]!r}")
    return text.replace(old, new)


def _split(text: str, new: str) -> str:
    if len(SPLIT.findall(text)) != 1:
        raise RuntimeError("variant edit does not apply once: split_tf32")
    return SPLIT.sub(lambda _: new, text)


def variants(src: str, header: str) -> dict[str, tuple[str, str, int]]:
    """{name: (source, header, blocks per SM)}."""
    running = _once(src, MMA_STAGE_SUM, MMA_STAGE_SUM.replace("d[i][j]", "acc[i][j]"))
    running = _once(running, "acc[i][j][e] += d[i][j][e];", "(void)d[i][j][e];")
    two = _once(src, "__launch_bounds__(NT, 1)", "__launch_bounds__(NT, 2)")
    two = _once(two, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")
    return {"as-is": (src, header, 1), "cvt": (src, _split(header, CVT), 1),
            "running": (running, header, 1),
            "one-pass": (_once(src, MMA_STAGE_SUM,
                               "          mma_tf32(d[i][j], ah, bh[j]);\n"), header, 1),
            "no-split": (src, _split(header, RAW), 1), "2-blocks": (two, header, 2)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="where the variant sources and libraries go (default: the "
                         "port's build directory)")
    args = ap.parse_args()

    import torch

    from chip_smoke import TRAIN_BATCH, TRAIN_SHAPES, _time_ms
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.ops import _build
    from dycon_paper_replication_tpu_torch.ops import folded_conv_cuda as fc

    device = resolve_device("cuda")
    args.out = args.out or str(_build.BUILD_DIR / "k1_dw_variants")
    os.makedirs(args.out, exist_ok=True)
    procs, blocks_per_sm = {}, {}
    header = fc.DW_SOURCE.parent / "tf32_mma.cuh"
    for name, (text, head, per_sm) in variants(fc.DW_SOURCE.read_text(),
                                               header.read_text()).items():
        blocks_per_sm[name] = per_sm
        # each variant in its own directory, beside its own copy of the header
        os.makedirs(os.path.join(args.out, name), exist_ok=True)
        src = os.path.join(args.out, name, fc.DW_SOURCE.name)
        for path, content in ((src, text), (os.path.join(args.out, name, header.name), head)):
            with open(path, "w") as f:
                f.write(content)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(args.out, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps(dict(variant=name, ptxas=[line.strip() for line in log.splitlines()
                                                   if "registers" in line or "spill" in line])))
        fn = getattr(ctypes.CDLL(os.path.abspath(os.path.join(args.out, f"{name}.so"))),
                     "dycon_folded_conv3_dw_f32")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kernels[name] = fc.FoldedConv3Dw()
        kernels[name]._fns[torch.float32] = fn

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for layer, g, lin, lout, to_phase in TRAIN_SHAPES:
        q = tuple(n + (1 if to_phase == 1 else -1) for n in g)
        x = torch.randn(TRAIN_BATCH, *g, lin, device=device, generator=gen)
        dy = torch.randn(TRAIN_BATCH, *q, lout, device=device, generator=gen)
        ref = fc.folded_conv3_dw_plain(x.double(), dy.double(), to_phase=to_phase)
        err_plain = (fc.folded_conv3_dw_plain(x, dy, to_phase=to_phase).double()
                     - ref).abs().max().item()
        gate = max(1e-4 * ref.abs().max().item(), 4 * err_plain)
        cases.append((layer, x, dy, to_phase, ref.float(), gate,
                      2 * TRAIN_BATCH * math.prod(q) * lin * lout * 8))
        del ref
    for rnd in range(2):
        for name, k in kernels.items():
            fc.DW_BLOCKS_PER_SM = blocks_per_sm[name]
            total = 0.0
            for layer, x, dy, to_phase, ref, gate, flops in cases:
                got = k.launch(x, dy, to_phase=to_phase)
                again = k.launch(x, dy, to_phase=to_phase)
                err = (got.double() - ref.double()).abs().max().item()
                ms = _time_ms(torch, lambda: k.launch(x, dy, to_phase=to_phase), reps=args.reps)
                total += ms
                print(json.dumps(dict(round=rnd, variant=name, layer=layer, ms=ms,
                                      tflops=flops / ms / 1e9, max_abs_err=err, gate=gate,
                                      bit_identical=torch.equal(got, again))), flush=True)
            print(json.dumps(dict(round=rnd, variant=name, sum_ms=total)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
