#!/usr/bin/env python3
"""Time and check the bf16 conv kernels on one GPU: K1-bf16 forward, its dx
and K1-dW-bf16 at the convs of one Pancreas (or VNet) training step at B 8,
through chip_smoke.py's phase_bf16_kernel (inputs standard normal from a
seed; the bf16 gate against a float64 conv of the same bf16 values, a rerun
bit-identical; ms by CUDA events beside cuDNN's bf16 fprop, dgrad or wgrad
and the bf16 bound).

    python3 scripts/time_k1_bf16.py [--shapes train|vnet] [--tag NAME]

Prints chip_smoke's per-shape JSON lines (tagged NAME + fwd / dx / dw), one
summary line per kernel (the sums over the shapes) and the card's name and
power limit. The port's package comes from PYTHONPATH before this checkout,
so the same script times another checkout's kernels in the same process
layout, e.g. the parent's unpacked by `git archive` into a gitignored
directory:

    PYTHONPATH=<other checkout> python3 scripts/time_k1_bf16.py --tag other
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", choices=("train", "vnet"), default="train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    import torch

    import dycon_paper_replication_tpu_torch as pkg
    from chip_smoke import (PEAKS, TRAIN_BATCH, TRAIN_SHAPES, VNET_TRAIN_SHAPES,
                            phase_bf16_kernel)
    from dycon_paper_replication_tpu_torch.config import resolve_device

    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    shapes = TRAIN_SHAPES if args.shapes == "train" else VNET_TRAIN_SHAPES
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for part in ("fwd", "dx", "dw"):
        rows = phase_bf16_kernel(torch, device, gen, peaks, shapes, TRAIN_BATCH, part,
                                 f"{args.tag}{part}")
        print(json.dumps(dict(tag=args.tag, package=os.path.dirname(pkg.__file__),
                              shapes=args.shapes, kernel=part,
                              ms=sum(r["ms"] for r in rows),
                              library_ms=sum(r["library_ms"] for r in rows),
                              bound_ms=sum(r["bound_ms"] for r in rows),
                              max_abs_err=max(r["max_abs_err"] for r in rows))), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
