#!/usr/bin/env python3
"""Where the time goes in one DyCON train step of the port on the GPU, at a
dataset's defaults: Pancreas (full-width UNet3D, folded layout, patch
112x112x96, batch 8 of which 4 labeled, dense FeCL with N = 2352) or ISLES
(patch 96x96x64, batch 8 of which 4 labeled, teacher in eval mode, the
fused FeCL over N = 9216 through K2), random weights and a synthetic batch
from a seed.

    python3 scripts/profile_torch_train.py [--config pancreas|isles22] [--reps 3]
        [--layout folded|NDHWC]

`--layout` picks the model layout (default: the config's, "folded" on
CUDA); NDHWC runs every level through cuDNN and never reaches K1.

It prints the wall ms per step (host clock around steps that end in a
device sync, median of --reps after 2 warm-up steps), the peak device
memory of a step, then the device time per step from torch.profiler grouped
as K1 (forward and dx), K1-dW, K2 (the fused FeCL), library convs and
matmuls (cuDNN, cuBLAS) and everything else (elementwise, reductions, copies), the share of each,
the device's idle share of the wall time, and the largest kernels. Last
line: one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_common import device_ms_by_category  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layout", choices=("folded", "NDHWC"), default=None)
    ap.add_argument("--config", choices=("pancreas", "isles22"), default="pancreas")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.config import make_config, resolve_device
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.train.state import create_train_state
    from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step

    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = make_config(args.config, device="cuda")
    net_cfg = UNet3DConfig(layout=args.layout or cfg.resolved_layout(device),
                           scale_factor=cfg.feature_scaler)
    params, state = weights.init_jax_tree(net_cfg, seed=args.seed)
    student = UNet3D(net_cfg).to(device)
    student.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    train_state = create_train_state(student)
    step = build_train_step(cfg, lambda s: cfg.base_lr)

    rng = np.random.default_rng(args.seed)
    shape = (cfg.batch_size, *cfg.patch_size)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in cfg.patch_size], indexing="ij"), -1)
    label = np.stack([(((grid - rng.uniform(0.3, 0.7, 3) * cfg.patch_size)
                        / (rng.uniform(0.15, 0.3, 3) * cfg.patch_size)) ** 2).sum(-1) <= 1.0
                      for _ in range(shape[0])]).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(shape)).astype(np.float32)[..., None]
    batch = {"image": torch.from_numpy(image).to(device),
             "label": torch.from_numpy(label).to(device)}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    scalars = StepScalars(5.0, 0.1 * float(np.exp(-5.0)), 1.3, 0.3)

    def run():
        return step(train_state, batch, gen, scalars).tolist()  # .tolist() syncs

    for _ in range(2):
        run()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            run()
    by_cat, kernels = device_ms_by_category(prof, args.reps)
    busy = sum(by_cat.values())
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"train step ({args.config}, {net_cfg.layout}): wall {wall_ms:.3f} ms (all "
          f"{[round(w, 3) for w in walls]}), device busy {busy:.3f} ms, idle share {idle:.3f}, "
          f"peak memory {peak_gib:.3f} GiB")
    for cat, ms in by_cat.items():
        print(f"   {cat:8s} {ms:9.3f} ms  {ms / busy if busy else 0:.3f}")
    for ms, cnt, key in kernels[:15]:
        print(f"   {ms:9.3f} ms  x{cnt:<4d} {key}")
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), config=args.config,
                          layout=net_cfg.layout,
                          wall_ms=wall_ms, walls_ms=walls,
                          device_busy_ms=busy, idle_share=idle, peak_gib=peak_gib,
                          **{f"{k}_ms": v for k, v in by_cat.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
