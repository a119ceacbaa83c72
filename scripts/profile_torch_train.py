#!/usr/bin/env python3
"""Where the time goes in one DyCON train step of the port on the GPU, at a
dataset's defaults: Pancreas (full-width UNet3D, folded layout, patch
112x112x96, batch 8 of which 4 labeled, dense FeCL with N = 2352), BraTS
(patch 96^3, batch 8 of which 4 labeled, dense FeCL with N = 1728) or ISLES
(patch 96x96x64, batch 8 of which 4 labeled, teacher in eval mode, the
fused FeCL over N = 9216 through K2), random weights and a synthetic batch
from a seed.

    python3 scripts/profile_torch_train.py [--config pancreas|brats19|isles22] [--reps 3]
        [--layout folded|NDHWC] [--model unet_3D|vnet] [--use_aspp 0|1] [--trace_dir DIR]

`--layout` picks the model layout (default: the config's, "folded" on
CUDA); NDHWC runs every level through cuDNN and never reaches K1.
`--model vnet` profiles the VNet (n_filters 16, BatchNorm throughout, six
folded convs), `--use_aspp 1` the UNet3D with ASPP on its bottleneck.

It prints the wall ms per step (host clock around steps that end in a
device sync, median of --reps after 2 warm-up steps), the peak device
memory of a step, then the device time per step from torch.profiler grouped
as K1 (forward and dx), K1-dW, K2 (the fused FeCL), library convs and
matmuls (cuDNN, cuBLAS) and everything else (elementwise, reductions, copies), the share of each,
the device's idle share of the wall time, and the largest kernels; the
profiled steps' Chrome trace goes to <--trace_dir>/trace.json
(utils/profiling.py:trace). Then the train-HD95 iterations' extra cost: the
time to bring a step's foreground mask (batch x patch) to the host as a
uint8 numpy array, unpacked (one copy of the uint8 mask) and packed (ops/bits.py:
pack on the card, copy, unpack on the host), each the median of --d2h_reps
runs in turns after a device sync, and the host time of train-HD95 over
that mask and the batch's labels (ops/metrics.py:compute_hd95_batch). Last
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
    ap.add_argument("--config", choices=("pancreas", "brats19", "isles22"), default="pancreas")
    ap.add_argument("--model", choices=("unet_3D", "vnet"), default="unet_3D")
    ap.add_argument("--use_aspp", type=int, choices=(0, 1), default=0)
    ap.add_argument("--d2h_reps", type=int, default=20)
    ap.add_argument("--trace_dir", default=None,
                    help="default runs/profile_torch_train_<config>[_vnet][_aspp]_<layout>")
    args = ap.parse_args()

    import numpy as np
    import torch

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.config import make_config, resolve_device
    from dycon_paper_replication_tpu_torch.models import build_model, model_config
    from dycon_paper_replication_tpu_torch.ops.bits import packbits_le, unpackbits_le
    from dycon_paper_replication_tpu_torch.ops.metrics import compute_hd95_batch
    from dycon_paper_replication_tpu_torch.train.state import create_train_state
    from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step
    from dycon_paper_replication_tpu_torch.utils.profiling import trace

    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = make_config(args.config, device="cuda", model=args.model, use_aspp=bool(args.use_aspp))
    net_cfg = model_config(args.model, scaler=cfg.feature_scaler, use_aspp=cfg.use_aspp,
                           layout=args.layout or cfg.resolved_layout(device))
    params, state = weights.init_jax_tree(net_cfg, seed=args.seed)
    student = build_model(net_cfg).to(device)
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
        vec, diag = step(train_state, batch, gen, scalars)
        vec.tolist()  # syncs
        return diag

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
    tag = args.config + ("_vnet" if args.model == "vnet" else "") + (
        "_aspp" if args.use_aspp else "")
    trace_dir = args.trace_dir or os.path.join("runs", f"profile_torch_train_{tag}_{net_cfg.layout}")
    with trace(trace_dir) as prof:
        for _ in range(args.reps):
            diag = run()
    by_cat, kernels = device_ms_by_category(prof, args.reps)
    busy = sum(by_cat.values())
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"train step ({tag}, {net_cfg.layout}): wall {wall_ms:.3f} ms (all "
          f"{[round(w, 3) for w in walls]}), device busy {busy:.3f} ms, idle share {idle:.3f}, "
          f"peak memory {peak_gib:.3f} GiB")
    for cat, ms in by_cat.items():
        print(f"   {cat:8s} {ms:9.3f} ms  {ms / busy if busy else 0:.3f}")
    for ms, cnt, key in kernels[:15]:
        print(f"   {ms:9.3f} ms  x{cnt:<4d} {key}")

    pred_fg = diag["pred_fg"]
    width = pred_fg.shape[-1]

    def unpacked():
        return pred_fg.cpu().numpy()

    def packed():
        return unpackbits_le(packbits_le(pred_fg).cpu().numpy(), width)

    want = unpacked()
    assert np.array_equal(packed(), want), "packbits_le / unpackbits_le do not round-trip"
    d2h = {"unpacked": [], "packed": []}
    for _ in range(args.d2h_reps):
        for name, fn in (("unpacked", unpacked), ("packed", packed), ("packed", packed),
                         ("unpacked", unpacked)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            d2h[name].append((time.perf_counter() - t0) * 1e3)
    d2h_ms = {k: statistics.median(v) for k, v in d2h.items()}
    t0 = time.perf_counter()
    hd95 = compute_hd95_batch(want, label, float(np.linalg.norm(cfg.patch_size)))
    hd95_ms = (time.perf_counter() - t0) * 1e3
    print(f"pred_fg {tuple(pred_fg.shape)} to the host: "
          f"unpacked {d2h_ms['unpacked']:.4f} ms, packed {d2h_ms['packed']:.4f} ms (median of "
          f"{2 * args.d2h_reps} each; {int(want.sum())} foreground voxels); train-HD95 on the "
          f"host {hd95_ms:.1f} ms (mean {float(np.mean(hd95)):.3f})")
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), config=args.config,
                          model=args.model, use_aspp=args.use_aspp, layout=net_cfg.layout,
                          wall_ms=wall_ms, walls_ms=walls,
                          device_busy_ms=busy, idle_share=idle, peak_gib=peak_gib,
                          **{f"{k}_ms": v for k, v in by_cat.items()},
                          pred_fg_d2h_unpacked_ms=d2h_ms["unpacked"],
                          pred_fg_d2h_packed_ms=d2h_ms["packed"], hd95_host_ms=hd95_ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
