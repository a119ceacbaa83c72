#!/usr/bin/env python3
"""Both packages' Pancreas Trainers from one seed on the CPU, step by step.

    python3 scripts/trajectory_jax_vs_port.py [--steps 60] [--patch_size 64 64 48] \
        [--batch_size 4] [--shape 80 80 64] [--n_train 8] [--seed 1337] [--out X.json]

The JAX package's Trainer and the port's, each built from the same flags
and seed with nothing handed across (no weights, noise, masks or kink
sides): since the port draws JAX's random streams (ops/threefry.py), they
start from the same weights and draw the same noise, dropout masks and
batches, and differ only in float32 arithmetic. Validation is off (its
cadence past the last step). Prints |port / JAX - 1| of the step scalars by
windows of steps (scripts/canonical_table_torch.py's `step_differences`)
and the signed mean of each scalar's ratio per window, which shows a drift
in one direction apart from noise. It is the CPU yardstick for the card's
run against the TPU's record (PERF.md §7): at a patch larger than the
tests' 32x32x16, so that FeCL runs over hundreds of rows.

Needs JAX (the reference package), unlike the port; on the CPU only. A
60-step run at the defaults takes ~10 minutes on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

WINDOWS = ((1, 1), (2, 10), (11, 30), (31, 60), (61, 100), (101, 200))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--patch_size", type=int, nargs=3, default=(64, 64, 48))
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--shape", type=int, nargs=3, default=(80, 80, 64))
    p.add_argument("--n_train", type=int, default=8)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--work", type=str, default=None, help="default: a temporary directory")
    p.add_argument("--out", type=str, default=None)
    return p


def _flags(args, root: str, runs: str) -> dict:
    return dict(root_dir=root, snapshot_root=runs, patch_size=tuple(args.patch_size),
                batch_size=args.batch_size, labeled_bs=args.batch_size // 2,
                labelnum=args.n_train // 2, max_iterations=20000, val_every=10 ** 6,
                save_every=10 ** 6, seed=args.seed, compute_dtype="float32")


def _run(trainer_mod, cfg, steps: int) -> str:
    """A Trainer's first `steps` iterations, its schedules those of
    `cfg.max_iterations`; returns its metrics.jsonl."""
    import dataclasses

    trainer = trainer_mod.Trainer(cfg)
    trainer.cfg = dataclasses.replace(trainer.cfg, max_iterations=steps)
    trainer.run()
    return os.path.join(trainer.snapshot_path, "metrics.jsonl")


def signed_means(rows, ref_rows, windows=WINDOWS) -> dict:
    """The mean of run / ref - 1 of each step scalar per window of steps."""
    import canonical_table_torch as table

    run, ref = table.by_tag(rows), table.by_tag(ref_rows)
    out: dict = {}
    for name in table.STEP_SCALARS:
        a, b = dict(run.get(f"info/{name}", [])), dict(ref.get(f"info/{name}", []))
        for lo, hi in windows:
            rel = [a[s] / b[s] - 1 for s in range(lo, hi + 1) if s in a and s in b and b[s]]
            if rel:
                out.setdefault(name, {})[f"{lo}-{hi}"] = statistics.mean(rel)
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)

    import canonical_table_torch as table
    from dycon_paper_replication_tpu import config as jconfig
    from dycon_paper_replication_tpu.train import trainer as jtrainer
    from dycon_paper_replication_tpu_torch import config as tconfig
    from dycon_paper_replication_tpu_torch.data import synthetic
    from dycon_paper_replication_tpu_torch.train import trainer as ttrainer

    with tempfile.TemporaryDirectory() as tmp:
        work = args.work or tmp
        root = os.path.join(work, "data")
        if not os.path.exists(os.path.join(root, "train.list")):
            synthetic.make_pancreas(root, n_train=args.n_train, n_test=1,
                                    shape=tuple(args.shape), seed=1)
        jax_metrics = _run(jtrainer, jconfig.make_config(
            "pancreas", data_parallel=1, **_flags(args, root, os.path.join(work, "jax"))),
            args.steps)
        port_metrics = _run(ttrainer, tconfig.make_config(
            "pancreas", device="cpu", **_flags(args, root, os.path.join(work, "port"))),
            args.steps)
        rows, ref = table.load_rows(port_metrics), table.load_rows(jax_metrics)
    out = dict(flags=vars(args), steps=table.step_differences(rows, ref, WINDOWS),
               signed=signed_means(rows, ref))
    for name, by_window in out["steps"].items():
        cells = ", ".join(f"{w}: {d['median']:.2e} / {d['max']:.2e} ({out['signed'][name][w]:+.2e})"
                          for w, d in by_window.items())
        print(f"|port / JAX - 1| {name} (median / max, signed mean): {cells}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
