#!/usr/bin/env python3
"""The SSL ablation on the port: full DyCON against its supervised slice on
the hard synthetic Pancreas task.

    python3 scripts/ssl_ablation_torch.py [--iters 2500] [--labelnum 3] [--seed 1337]

Counterpart of scripts/exp_ssl_ablation.py, with the same flags and
defaults plus `--device` (cuda, or cpu). On data/synthetic.py's
make_hard_pancreas tree (made at `--root` when it holds no train.list, as
.npz cases), two arms train through the port's Pancreas Trainer at the same
seed and geometry:

  sup   - CE + Dice alone (u_weight 0, consistency 0): the labeled slice
          of the DyCON objective; UnCL and FeCL are still computed and
          logged, with weight 0
  dycon - the full objective

each with labeled_bs = batch_size // 2, val_every = max(iters // 10, 100)
unless given, save_every = iters, and the consistency ramp scaled to the
run (200 epochs of 20000 iterations in the reference: 200 * iters / 20000).
Each arm prints one JSON line (best validation Dice, final iteration, and
its wall seconds, median ms per step over the trainer's last 200 steps and
peak device memory); then test_pancreas runs on each arm's best checkpoint
over test.list (stride = patch // 2, float32) and each arm prints its line
again with the test Dice, Jaccard, HD95 and ASD, then `FINAL {...}`.

A long run can go in legs, each a fresh process: `--train_only` (repeat
with `--resume auto` while final_iter < iters), then `--test_only`.
Everything computes in float32. `--seed` changes the trainer's randomness
(initial weights, sampling, noise, dropout); the dataset is fixed by its
own seed, 7.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from dycon_paper_replication_tpu_torch.cli import test_pancreas  # noqa: E402
from dycon_paper_replication_tpu_torch.config import make_config  # noqa: E402
from dycon_paper_replication_tpu_torch.data.synthetic import make_hard_pancreas  # noqa: E402
from dycon_paper_replication_tpu_torch.train.trainer import Trainer  # noqa: E402

ARM_OVERRIDES = {"sup": dict(u_weight=0.0, consistency=0.0), "dycon": dict()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--labelnum", type=int, default=3)
    p.add_argument("--arms", type=str, default="sup,dycon")
    p.add_argument("--root", type=str, default=os.path.join(ROOT, "runs", "hard_pancreas"))
    p.add_argument("--work", type=str, default=os.path.join(ROOT, "runs", "ablation_runs"))
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, nargs=3, default=(64, 64, 48))
    p.add_argument("--val_every", type=int, default=None)
    p.add_argument("--n_train", type=int, default=40)
    p.add_argument("--n_test", type=int, default=8)
    p.add_argument("--shape", type=int, nargs=3, default=(96, 96, 64))
    p.add_argument("--time_budget_s", type=float, default=0.0,
                   help="clean, resumable stop of each training arm after this many seconds "
                        "(0: none)")
    p.add_argument("--seed", type=int, default=None,
                   help="the trainer's seed (initial weights and sampling); the dataset "
                        "stays fixed")
    p.add_argument("--test_only", action="store_true",
                   help="skip training; test each arm's best checkpoint under --work")
    p.add_argument("--train_only", action="store_true",
                   help="train the arms and exit before the test")
    p.add_argument("--resume", type=str, default="",
                   help='passed to the trainer ("auto": the arm\'s latest checkpoint)')
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def arm_config(args, arm: str):
    """The Pancreas TrainConfig of one arm."""
    return make_config(
        "pancreas", root_dir=args.root, snapshot_root=os.path.join(args.work, arm),
        exp=f"hard_{arm}", patch_size=tuple(args.patch_size), batch_size=args.batch_size,
        labeled_bs=args.batch_size // 2, labelnum=args.labelnum, max_iterations=args.iters,
        val_every=args.val_every or max(args.iters // 10, 100), save_every=args.iters,
        base_lr=args.base_lr, time_budget_s=args.time_budget_s,
        consistency_rampup=200.0 * args.iters / 20000.0, resume=args.resume,
        device=args.device, **({"seed": args.seed} if args.seed is not None else {}),
        **ARM_OVERRIDES[arm])


def test_argv(args, arm: str) -> list[str]:
    """test_pancreas's flags for one arm's best checkpoint."""
    return ["--root_path", args.root, "--snapshot_root", os.path.join(args.work, arm),
            "--exp", f"hard_{arm}", "--labelnum", str(args.labelnum),
            "--max_iterations", str(args.iters),
            "--patch_size", *[str(v) for v in args.patch_size],
            "--stride_xy", str(args.patch_size[0] // 2),
            "--stride_z", str(args.patch_size[2] // 2),
            "--list_name", "test.list", "--device", args.device, "--compute_dtype", "float32"]


def train_arm(args, arm: str) -> dict:
    cfg = arm_config(args, arm)
    print(f"=== arm {arm}: training {args.iters} iters ===", flush=True)
    on_cuda = torch.device(args.device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    best = trainer.run()
    out = dict(best_val_dice=float(best), final_iter=int(trainer.state.step),
               wall_s=time.perf_counter() - t0,
               step_ms_p50=trainer.timer.stats().get("step_ms_p50"))
    if on_cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if not os.path.exists(os.path.join(args.root, "train.list")):
        print("generating hard dataset ...", flush=True)
        make_hard_pancreas(args.root, n_train=args.n_train, n_test=args.n_test,
                           shape=tuple(args.shape), suffix=".npz")

    arms = args.arms.split(",")
    results = {arm: {} for arm in arms}
    for arm in () if args.test_only else arms:
        results[arm] = train_arm(args, arm)
        print(json.dumps({"arm": arm, **results[arm]}), flush=True)
    if args.train_only:
        return results

    for arm in arms:
        dice, jaccard, hd95, asd = test_pancreas.main(test_argv(args, arm))
        results[arm].update(test_dice=float(dice), test_jaccard=float(jaccard),
                            test_hd95=float(hd95), test_asd=float(asd))
        print(json.dumps({"arm": arm, **results[arm]}), flush=True)
    print("FINAL", json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
