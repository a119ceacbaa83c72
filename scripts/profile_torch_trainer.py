#!/usr/bin/env python3
"""The port's trainer end to end on the GPU at the BraTS-2019 defaults (or
the Pancreas ones): ms per training iteration of the whole host loop
(loader, step, logging and train-HD95), with train-HD95 scored three ways,
at --fetch_ahead 0 and 1.

    python3 scripts/profile_torch_trainer.py [--steps 101] [--modes thread,inline,off]
        [--fetch_ahead 0,1,1,0] [--dataset pancreas --extra "--model vnet --compute_dtype bfloat16"]

A synthetic BraTS tree (30 training + 2 validation .npz cases stored as
(128, 112, 100), from --seed; with --dataset pancreas a Pancreas tree of
16 + 2 cases of (120, 120, 100)) is written to a temporary directory, then for
each fetch_ahead setting of --fetch_ahead in turn (the trainer's pipelined
loop at 1, its default; the synchronous one at 0) and each mode of --modes
the BraTS train CLI's Trainer runs --steps iterations at
the brats19 defaults (patch 96^3, batch 8 of which 4 labeled, val_every 200,
so hd95_every 50: train-HD95 at iterations 1, 50, 100, ...; no validation
and no save within 101 steps), random weights from --seed:
  * thread: as the trainer ships, the mask copied to the host and scored on
    the trainer's worker thread while the loop goes on;
  * inline: scored in the loop before the next step (the worker pool
    replaced by one that runs each job as it is submitted);
  * off: no train-HD95.
ms per iteration is the time from the second step's start to the last
step's start over the iterations between, so it counts every host action
of the loop and leaves out the first step and the final wait for the
scores still pending. Each mode also gives the median step time (the
trainer's StepTimer: step to scalars on the host), the whole run's wall,
and, over the iterations after the first 4, the median host time of a
step's dispatch, the median device span of a step (CUDA events before and
after its dispatch) and the device's idle share between steps (the gaps
from one step's end event to the next one's start, over the whole span).
--extra passes more train flags (e.g. --model vnet).
The card's name and power limit come first; the last line is one JSON
object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import Future

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class InlinePool:
    """A stand-in for the trainer's worker pool that runs each job at once."""

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args):
        future = Future()
        future.set_result(fn(*args))
        return future

    def shutdown(self, **kwargs):
        pass


def run_mode(mode: str, root: str, runs: str, steps: int, seed: int,
             device: str = "cuda", extra: tuple = (), fetch_ahead: int = 1,
             dataset: str = "brats19") -> dict:
    from dycon_paper_replication_tpu_torch.config import config_from_args
    from dycon_paper_replication_tpu_torch.train import trainer as trainer_mod

    argv = ["--root_dir", root, "--snapshot_root", runs, "--device", device,
            "--max_iterations", str(steps), "--seed", str(seed),
            "--fetch_ahead", str(fetch_ahead), *extra]
    trainer = trainer_mod.Trainer(config_from_args(dataset, argv))
    if mode == "off":
        trainer._hd95_due = lambda iter_num: False
    starts, marks = [], []

    def timed(step):
        def timed_step(*args):
            import torch

            starts.append(time.perf_counter())
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
            out = step(*args)
            end.record()
            marks.append((begin, end, time.perf_counter() - starts[-1]))
            return out
        return timed_step

    full, light = trainer.train_step, trainer.train_step_light
    trainer.train_step = timed(full)
    trainer.train_step_light = trainer.train_step if light is full else timed(light)
    pool = trainer_mod.ThreadPoolExecutor
    if mode == "inline":
        trainer_mod.ThreadPoolExecutor = InlinePool
    t0 = time.perf_counter()
    try:
        trainer.run()
    finally:
        trainer_mod.ThreadPoolExecutor = pool
    wall_s = time.perf_counter() - t0
    n_hd95 = sum(1 for line in open(os.path.join(trainer.snapshot_path, "metrics.jsonl"))
                 if json.loads(line)["tag"] == "train/HD95")
    ms_per_iter = (starts[-1] - starts[1]) / (len(starts) - 2) * 1e3
    import torch

    torch.cuda.synchronize()
    steady = marks[4:]
    gaps = sum(a[1].elapsed_time(b[0]) for a, b in zip(steady, steady[1:]))
    out = dict(mode=mode, fetch_ahead=fetch_ahead, ms_per_iter=ms_per_iter,
               dispatch_ms=statistics.median(m[2] * 1e3 for m in steady),
               step_span_ms=statistics.median(m[0].elapsed_time(m[1]) for m in steady),
               idle=gaps / steady[0][0].elapsed_time(steady[-1][1]),
               step_ms_p50=statistics.median(trainer.timer.window) * 1e3,
               run_wall_s=wall_s, steps=len(starts), hd95_logged=n_hd95,
               hd95_every=trainer.hd95_every)
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=101)
    ap.add_argument("--modes", default="thread")
    ap.add_argument("--fetch_ahead", default="0,1,1,0",
                    help="the settings to run, in turn, each with every mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="brats19", choices=["brats19", "pancreas"])
    ap.add_argument("--extra", default="", help="more train flags, one string")
    args = ap.parse_args()
    import torch

    from dycon_paper_replication_tpu_torch.data import make_brats19
    from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        if args.dataset == "brats19":
            make_brats19(root, n_train=30, n_test=2, shape=(128, 112, 100), seed=args.seed,
                         suffix=".npz")
        else:
            make_pancreas(root, n_train=16, n_test=2, shape=(120, 120, 100), seed=args.seed,
                          suffix=".npz")
        runs = [(int(fa), mode) for fa in args.fetch_ahead.split(",")
                for mode in args.modes.split(",")]
        for i, (fa, mode) in enumerate(runs):
            results.append(run_mode(mode, root, os.path.join(tmp, f"runs{i}"), args.steps,
                                    args.seed, extra=tuple(args.extra.split()), fetch_ahead=fa,
                                    dataset=args.dataset))
    by_mode = {f"{m} fetch_ahead {fa}": [r["ms_per_iter"] for r in results
                                         if (r["mode"], r["fetch_ahead"]) == (m, fa)]
               for m, fa in dict.fromkeys((r["mode"], r["fetch_ahead"]) for r in results)}
    for mode, ms in by_mode.items():
        print(f"{mode:20s} ms per iteration {ms}")
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), runs=results,
                          ms_per_iter=by_mode)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
