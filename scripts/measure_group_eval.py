#!/usr/bin/env python3
"""Volume groups, pipelining and host staging of the port's evaluation on
the GPU, at the JAX headline protocol: seeded volumes of (192, 192, 64),
patch 96^3, stride 16/4 (49 patches a volume), the full-width folded UNet3D
(random weights from a seed), patch batch 4.

    python3 scripts/measure_group_eval.py [--volumes 8] [--groups 1 2 4 8]
        [--depths 1 2] [--dtypes float32 bfloat16] [--reps 2]

Prints, each on its own line:
  * staging: ms per group of V = --volumes volumes from host arrays to the
    card, through a pinned buffer (non_blocking) and through a fresh numpy
    stack (pageable), in turns, the median of --staging_reps each;
  * for each compute dtype, group and depth: the sliding window's vols/s
    over the volumes with the test CLI's host work on each result (largest
    component, Dice / Jaccard / HD95 / ASD), the engine's vols/s with no
    host work, and the device-resident ceiling of that group size
    (`device_resident_runner`: no host traffic), the best of --reps runs;
    then the staging modes end to end at the largest group and depth;
  * the ISLES whole-volume engine at its protocol: --volumes volumes of
    (112, 112, 73), the UNet3D with projection scale 4, float32, groups
    --isles_groups, depth 2, with the test CLI's per-case metrics;
  * the card's name and power limit (nvidia-smi), and last one JSON object
    with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", type=int, default=8)
    ap.add_argument("--groups", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--isles_groups", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--staging_reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume
    from dycon_paper_replication_tpu_torch.eval import SlidingWindowInference, WholeVolumeInference
    from dycon_paper_replication_tpu_torch.eval.evaluator import isles_case_metrics
    from dycon_paper_replication_tpu_torch.eval import sliding_window
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops import metrics
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import folded_conv3

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    vols = [_ellipsoid_volume(rng, (192, 192, 64)) for _ in range(args.volumes)]
    images = [v[0] for v in vols]
    result = {"device": torch.cuda.get_device_name(0), "smi": smi, "volumes": args.volumes}

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def pageable(arrays, dtype, dev):
        """The staging the engine does not use: a fresh numpy stack."""
        return torch.from_numpy(np.stack([np.asarray(a, dtype) for a in arrays])).to(dev)

    stagings = {"pinned": sliding_window.stage, "pageable": pageable}
    stage_ms = {"pinned": [], "pageable": []}
    for _ in range(args.staging_reps):
        for mode, fn in stagings.items():
            stage_ms[mode].append(sync_ms(lambda: fn(images, np.float32, device)))
    result["staging_ms_per_group"] = {k: float(np.median(v)) for k, v in stage_ms.items()}
    print(f"staging, V {args.volumes}: pinned {result['staging_ms_per_group']['pinned']:.3f} ms, "
          f"pageable {result['staging_ms_per_group']['pageable']:.3f} ms per group "
          f"(median of {args.staging_reps}; all {stage_ms})", flush=True)

    params, state = weights.init_jax_tree(UNet3DConfig(), seed=args.seed)
    sd = weights.jax_tree_to_state_dict(params, state)

    def cli_work(pred, label):
        pred = metrics.largest_connected_component(pred)
        return metrics.calculate_metric_percase(pred, label) if pred.sum() else (0.0,) * 4

    def run_map(sw, group, depth, host_work):
        folded_conv3.launches = 0
        t0 = time.perf_counter()
        n = 0
        for pred, _, label in sw.map(vols, group=group, depth=depth):
            if host_work:
                cli_work(pred, label)
            n += 1
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0), folded_conv3.launches

    sw_rows = []
    for dtype in args.dtypes:
        net = UNet3D(UNet3DConfig(layout="folded", compute_dtype=getattr(torch, dtype)))
        net = net.to(device).eval()
        net.load_state_dict(sd)
        transfer = np.float16 if dtype == "bfloat16" else np.float32
        sw = SlidingWindowInference(net, (96, 96, 96), 16, 4, patch_batch=4,
                                    transfer_dtype=transfer)
        run_map(sw, 1, 1, False)  # warm-up: kernels, cuDNN plans
        for group in args.groups:
            runner = sw.device_resident_runner([np.asarray(im, transfer) for im in images[:group]])
            runner()
            ceiling = group / (min(sync_ms(runner) for _ in range(args.reps)) / 1e3)
            for depth in args.depths:
                cli = max(run_map(sw, group, depth, True)[0] for _ in range(args.reps))
                engine, launches = max(run_map(sw, group, depth, False) for _ in range(args.reps))
                row = dict(dtype=dtype, group=group, depth=depth, cli_vols_per_s=cli,
                           engine_vols_per_s=engine, resident_vols_per_s=ceiling,
                           k1_launches=launches)
                sw_rows.append(row)
                print("sliding_window", json.dumps(row), flush=True)
        del sw, net
    result["sliding_window"] = sw_rows

    # the staging modes end to end at the largest group and depth (float32)
    net = UNet3D(UNet3DConfig(layout="folded")).to(device).eval()
    net.load_state_dict(sd)
    g, d = max(args.groups), max(args.depths)
    e2e = {}
    sw = SlidingWindowInference(net, (96, 96, 96), 16, 4, patch_batch=4)
    for _ in range(args.reps):
        for mode, fn in stagings.items():
            sliding_window.stage = fn  # the engine's staging, swapped for the comparison
            try:
                e2e.setdefault(mode, []).append(run_map(sw, g, d, True)[0])
            finally:
                sliding_window.stage = stagings["pinned"]
    result["staging_cli_vols_per_s"] = {k: max(v) for k, v in e2e.items()}
    print(f"staging end to end, group {g} depth {d}, float32, CLI work: "
          f"{json.dumps(e2e)} vols/s", flush=True)

    # the ISLES whole-volume protocol
    params, state = weights.init_jax_tree(UNet3DConfig(scale_factor=4), seed=args.seed)
    net = UNet3D(UNet3DConfig(layout="folded", scale_factor=4)).to(device).eval()
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    isles = [_ellipsoid_volume(rng, (112, 112, 73)) for _ in range(args.volumes)]
    wv = WholeVolumeInference(net, (96, 96, 64))
    list(wv.map(isles[:1]))
    wv_rows = []
    for group in args.isles_groups:
        best = 0.0
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for pred, label in wv.map(isles, group=group, depth=2):
                isles_case_metrics(pred, label)
            best = max(best, len(isles) / (time.perf_counter() - t0))
        wv_rows.append(dict(group=group, depth=2, cli_vols_per_s=best))
        print("whole_volume", json.dumps(wv_rows[-1]), flush=True)
    result["whole_volume"] = wv_rows
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
