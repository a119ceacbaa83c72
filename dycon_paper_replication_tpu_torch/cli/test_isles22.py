"""Offline ISLES-2022 evaluation: the best checkpoint of the flag-derived
snapshot path, one whole-volume forward per val.list case (the seg head),
per-case Dice/HD95/ASD/sensitivity/specificity, the mean and std table and
a test_results_labelnum<N>.txt file in the snapshot directory.

Counterpart of dycon_paper_replication_tpu/cli/test_isles22.py, with the
flags the port implements plus `--device` (default cuda); `--compute_dtype`
auto is bfloat16 on cuda and float32 on the CPU (test_pancreas.resolve_perf_flags
says why). `--group N` stacks N volumes of one padded
shape into one forward; 0, the default, is eval.AUTO_GROUP["whole_volume"]["test"]
= 2 on cuda, the best of groups 1, 2 and 4 at the ISLES protocol on the card
(scripts/measure_group_eval.py, NVIDIA H100 80GB HBM3, 700 W: 2.249 / 2.498
/ 2.086 vols/s over 8 volumes of (112, 112, 73) with this CLI's metrics),
and 1 on the CPU.
`--data_parallel N` deals the groups round-robin over N cards, one model
replica each, in this process. Run as
    python -m dycon_paper_replication_tpu_torch.cli.test_isles22 --root_dir DATA ...
"""

from __future__ import annotations

import argparse
import os

from ..config import COMPUTE_DTYPES, LAYOUTS, make_config, resolve_device
from ..data import ISLESDataset
from ..eval import (AUTO_GROUP, WholeVolumeInference, auto_group, iter_volumes,
                    test_all_case_wholevolume)
from ..models import net_factory_3d
from ..parallel import eval_devices
from ..utils import checkpoint
from .test_pancreas import resolve_perf_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", type=str, default="../data/ISLES22")
    p.add_argument("--exp", type=str, default="ISLES22")
    p.add_argument("--model", type=str, choices=["unet_3D", "vnet"], default="unet_3D")
    p.add_argument("--use_aspp", type=int, default=0, choices=[0, 1],
                   help="the checkpoint's UNet3D has ASPP (evaluation does not run it)")
    p.add_argument("--labelnum", type=int, default=10)
    p.add_argument("--temp", type=float, default=0.6)
    p.add_argument("--consistency_type", type=str, default="mse")
    p.add_argument("--max_iterations", type=int, default=20000)
    p.add_argument("--in_ch", type=int, default=1)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--feature_scaler", type=int, default=4)
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 64])
    p.add_argument("--snapshot_root", type=str, default="./runs")
    p.add_argument("--compute_dtype", type=str, default="auto",
                   choices=["auto", *COMPUTE_DTYPES],
                   help="auto = bfloat16 on cuda, float32 on cpu")
    p.add_argument("--layout", type=str, default="auto", choices=LAYOUTS)
    p.add_argument("--patch_batch", type=int, default=0)  # accepted for symmetry
    p.add_argument("--data_parallel", type=int, default=0,
                   help="deal volume groups round-robin over N devices, one model replica "
                        "each (0/1 = the model's device)")
    p.add_argument("--group", type=int, default=0,
                   help="volumes of one padded shape per forward (0 = auto: "
                        f"{AUTO_GROUP['whole_volume']['test']} on cuda, 1 on cpu)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dtype, layout, _ = resolve_perf_flags(args)
    cfg = make_config(
        "isles22", exp=args.exp, model=args.model, labelnum=args.labelnum, temp=args.temp,
        consistency_type=args.consistency_type, max_iterations=args.max_iterations,
        in_ch=args.in_ch, feature_scaler=args.feature_scaler, snapshot_root=args.snapshot_root,
    )
    snapshot_path = cfg.snapshot_path()
    device = resolve_device(args.device)
    model = net_factory_3d(args.model, in_chns=args.in_ch, class_num=args.num_classes,
                           scaler=args.feature_scaler, use_aspp=args.use_aspp, layout=layout,
                           device=device, compute_dtype=COMPUTE_DTYPES[dtype])
    ckpt_path = checkpoint.best_checkpoint_path(snapshot_path, args.model)
    checkpoint.restore_checkpoint(ckpt_path, model)
    print(f"Loading best model from: {ckpt_path}")

    ds = ISLESDataset(args.root_dir, split="val")
    devices = eval_devices(device, args.data_parallel)
    if devices:
        print(f"Volume-parallel eval over {len(devices)} devices")
    wv = WholeVolumeInference(model, tuple(args.patch_size), devices=devices)
    results_file = os.path.join(snapshot_path, f"test_results_labelnum{args.labelnum}.txt")
    group = args.group or auto_group(device, "whole_volume", "test")
    summary = test_all_case_wholevolume(wv, iter_volumes(ds.paths, label_key="mask"),
                                        results_path=results_file, group=group)
    print("=" * 60)
    print("TESTING RESULTS FOR ISLES22")
    print("=" * 60)
    print(f"{'Metric':<12} | {'Mean':<8} | {'Std':<8}")
    for k in ("dice", "hd95", "asd", "sensitivity", "specificity"):
        print(f"{k.upper():<12} | {summary[k]:<8.4f} | {summary[k + '_std']:<8.4f}")
    print("=" * 60)
    return summary


if __name__ == "__main__":
    main()
