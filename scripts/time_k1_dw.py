#!/usr/bin/env python3
"""Time K1-dW (`ops/folded_conv_cuda.py:folded_conv3_dw`) on one GPU at the 8
convs of one Pancreas training step (B 8, patch 112x112x96: chip_smoke.py's
TRAIN_SHAPES), inputs standard normal from a seed.

    python3 scripts/time_k1_dw.py [--reps 10] [--tag NAME]

Prints one JSON line per shape (ms per launch by CUDA events over --reps
launches after one warm-up, TFLOP/s) and a last line with the sum and the
card's name and power limit. The port's package comes from PYTHONPATH
before this checkout, so the same script times another checkout's kernel
in the same process layout:

    PYTHONPATH=<other checkout> python3 scripts/time_k1_dw.py --tag other
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    import torch

    import dycon_paper_replication_tpu_torch as pkg
    from chip_smoke import TRAIN_BATCH, TRAIN_SHAPES, _time_ms
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3_dw

    device = resolve_device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    total = 0.0
    for layer, g, lin, lout, to_phase in TRAIN_SHAPES:
        q = tuple(n + (1 if to_phase == 1 else -1) for n in g)
        x = torch.randn(TRAIN_BATCH, *g, lin, device=device, generator=gen)
        dy = torch.randn(TRAIN_BATCH, *q, lout, device=device, generator=gen)
        ms = _time_ms(torch, lambda: folded_conv3_dw.launch(x, dy, to_phase=to_phase),
                      reps=args.reps)
        total += ms
        flops = 2 * TRAIN_BATCH * math.prod(q) * lin * lout * 8
        print(json.dumps(dict(tag=args.tag, layer=layer, ms=ms, tflops=flops / ms / 1e9)),
              flush=True)
        del x, dy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(tag=args.tag, package=os.path.dirname(pkg.__file__), sum_ms=total,
                          card=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
