#!/usr/bin/env python3
"""Where the time goes in one patch-batch forward of the port's UNet3D on
the GPU: the folded model (fold-2 levels through K1) and the plain model
(cuDNN convs), full width, patch 96^3, random weights from a seed.

    python3 scripts/profile_torch_eval.py [--batch 4] [--reps 5]

For each model it prints the wall ms per forward (CUDA events), then the
device time per forward from torch.profiler grouped as K1, K1-dW (none in
a forward), cuDNN/cuBLAS convs and matmuls and everything else
(elementwise, reductions, copies; `profile_common.category`), the share of
each, and the device's idle share of the wall time. Last line: one JSON
object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_common import device_ms_by_category  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops.folding import fold2

    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=args.seed)
    sd = weights.jax_tree_to_state_dict(params, state)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.rand(args.batch, 96, 96, 96, 1, device=device, generator=gen)
    xf = fold2(x)
    result = {"device": torch.cuda.get_device_name(0), "batch": args.batch}
    for layout in ("folded", "NDHWC"):
        net = UNet3D(UNet3DConfig(layout=layout)).to(device).eval()
        net.load_state_dict(sd)
        if layout == "folded":
            fwd = lambda: net.apply_seg_folded(xf)  # noqa: E731
        else:
            fwd = lambda: net(x, with_projection=False)[1]  # noqa: E731
        with torch.inference_mode():
            fwd()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fwd()
            end.record()
            torch.cuda.synchronize()
            wall_ms = start.elapsed_time(end) / args.reps
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    fwd()
                torch.cuda.synchronize()
        by_cat, kernels = device_ms_by_category(prof, args.reps)
        busy = sum(by_cat.values())
        print(f"== {layout}: wall {wall_ms:.3f} ms per forward, device busy {busy:.3f} ms, "
              f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
        for cat, ms in by_cat.items():
            print(f"   {cat:8s} {ms:9.3f} ms  {ms / busy if busy else 0:.3f}")
        for ms, cnt, key in kernels[:12]:
            print(f"   {ms:9.3f} ms  x{cnt:<4d} {key}")
        result[layout] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                              idle_share=max(0.0, 1 - busy / wall_ms),
                              **{f"{k}_ms": v for k, v in by_cat.items()})
        del net
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
