"""Offline Pancreas-CT evaluation: load the best checkpoint of the
flag-derived snapshot path (`--model unet_3D` or `vnet`), run the dense
sliding-window protocol (patch 96^3, stride_xy 16, stride_z 4) over the
test list, print the per-case and average Dice/Jaccard/HD95/ASD table.

Counterpart of dycon_paper_replication_tpu/cli/test_pancreas.py, with the
same flags plus `--device` (default cuda). Run as
    python -m dycon_paper_replication_tpu_torch.cli.test_pancreas --root_path DATA ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import COMPUTE_DTYPES, make_config, resolve_device
from ..eval import SlidingWindowInference, iter_volumes, test_all_case
from ..models import net_factory_3d
from ..utils import checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/Pancreas")
    p.add_argument("--exp", type=str, default="PancreasCT")
    p.add_argument("--model", type=str, choices=["unet_3D", "vnet"], default="unet_3D")
    p.add_argument("--use_aspp", type=int, default=0, choices=[0, 1],
                   help="the checkpoint's UNet3D has ASPP (evaluation does not run it)")
    p.add_argument("--detail", type=int, default=1)
    p.add_argument("--nms", type=int, default=1)
    p.add_argument("--labelnum", type=int, default=12)
    p.add_argument("--gamma", type=float, default=2.0)
    p.add_argument("--beta_min", type=float, default=0.5)
    p.add_argument("--beta_max", type=float, default=5.0)
    p.add_argument("--s_beta", type=float, default=None)
    p.add_argument("--temp", type=float, default=0.6)
    p.add_argument("--use_focal", type=int, default=1)
    p.add_argument("--use_teacher_loss", type=int, default=1)
    p.add_argument("--consistency_type", type=str, default="mse")
    p.add_argument("--max_iterations", type=int, default=20000)
    p.add_argument("--in_ch", type=int, default=1)
    p.add_argument("--feature_scaler", type=int, default=2)
    p.add_argument("--snapshot_root", type=str, default="./runs")
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    p.add_argument("--stride_xy", type=int, default=16)
    p.add_argument("--stride_z", type=int, default=4)
    p.add_argument("--gpu_id", type=str, default="0")
    p.add_argument("--list_name", type=str, default="test1.list")
    p.add_argument("--compute_dtype", type=str, default="auto",
                   choices=["auto", *COMPUTE_DTYPES],
                   help="auto = float32 (bfloat16 runs only when asked for)")
    p.add_argument("--layout", type=str, default="auto", choices=["auto", "NDHWC", "folded"])
    p.add_argument("--patch_batch", type=int, default=0,
                   help="patches per forward; 0 = auto (4 on cuda, 2 on cpu)")
    # mesh sharding and volume groups are not ported yet: 0 and 1 only
    p.add_argument("--data_parallel", type=int, default=0, choices=[0, 1])
    p.add_argument("--group", type=int, default=0, choices=[0, 1])
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def resolve_perf_flags(args) -> tuple[str, str, int]:
    """(compute_dtype, layout, patch_batch) for the device: folded (unet_3D
    and vnet alike) and 4 patches per forward on cuda, the plain layout and
    2 on the CPU. `--compute_dtype auto` is float32 on both (the JAX CLI's
    auto is bfloat16 on a TPU only); bfloat16 runs when asked for."""
    on_cuda = args.device == "cuda"
    layout = args.layout if args.layout != "auto" else ("folded" if on_cuda else "NDHWC")
    patch_batch = args.patch_batch or (4 if on_cuda else 2)
    dtype = "float32" if args.compute_dtype == "auto" else args.compute_dtype
    return dtype, layout, patch_batch


def run_test(args, dataset: str, volume_iter) -> tuple:
    cfg = make_config(
        dataset,
        exp=args.exp, model=args.model, labelnum=args.labelnum, gamma=args.gamma,
        beta_min=args.beta_min, beta_max=args.beta_max, s_beta=args.s_beta,
        temp=args.temp, use_focal=args.use_focal, use_teacher_loss=args.use_teacher_loss,
        consistency_type=args.consistency_type, max_iterations=args.max_iterations,
        in_ch=args.in_ch, feature_scaler=args.feature_scaler,
        snapshot_root=args.snapshot_root,
    )
    snapshot_path = cfg.snapshot_path()
    device = resolve_device(args.device)
    dtype, layout, patch_batch = resolve_perf_flags(args)
    model = net_factory_3d(args.model, in_chns=args.in_ch, class_num=cfg.num_classes,
                           scaler=args.feature_scaler, use_aspp=args.use_aspp, layout=layout,
                           device=device, compute_dtype=COMPUTE_DTYPES[dtype])
    ckpt_path = checkpoint.best_checkpoint_path(snapshot_path, args.model)
    checkpoint.restore_checkpoint(ckpt_path, model)
    print(f"init weight from {ckpt_path}")

    # the JAX CLI's transfer dtype: the image rounded through float16 in bfloat16
    sw = SlidingWindowInference(model, tuple(args.patch_size), args.stride_xy, args.stride_z,
                                patch_batch=patch_batch,
                                transfer_dtype=np.float16 if dtype == "bfloat16" else np.float32)
    save_path = os.path.join(snapshot_path, f"{args.exp}_predictions")
    avg = test_all_case(sw, volume_iter, nms=bool(args.nms), metric_detail=bool(args.detail),
                        test_save_path=save_path)
    print("=" * 60)
    print("FINAL AVERAGE METRICS:")
    print(f"{'Dice':<8} {'Jaccard':<8} {'HD95':<8} {'ASD':<8}")
    print(f"{avg[0]:<8.5f} {avg[1]:<8.5f} {avg[2]:<8.5f} {avg[3]:<8.5f}")
    print("=" * 60)
    return tuple(avg)


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(os.path.join(args.root_path, args.list_name)) as f:
        names = [line.strip() for line in f if line.strip()]
    paths = [os.path.join(args.root_path, "Pancreas_data", n) for n in names]
    return run_test(args, "pancreas", iter_volumes(paths))


if __name__ == "__main__":
    main()
