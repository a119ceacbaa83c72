#!/usr/bin/env python3
"""The SSL ablation's 3-seed table on the port, beside the TPU's.

    python3 scripts/ssl_ablation_table.py [--seeds 1337 2337 3337] [--out FILE.json]

Runs scripts/ssl_ablation_torch.py at its defaults (2500 iterations, both
arms, then the dense test) once per seed, each in a fresh process, with
one hard tree shared by all seeds (made by the first) and a work directory
per seed; each run's output goes to <--logs>/seed<S>.log. Then prints each
seed's best validation Dice of both arms beside the JAX package's TPU run
of the same protocol (bench_results/r04_queue_overnight.json,
`ssl_ablation_reproducibility`, copied below), the gates:
  (a) DyCON's best validation Dice above the sup arm's at every seed;
  (b) the mean gain over the seeds at least +0.025 (half the TPU's +0.051);
  (c) each arm's mean best validation Dice within 0.03 of the TPU's mean;
each as met or missed, and, not gated, the test Dice, Jaccard, HD95 and ASD
beside the TPU's, ms per step, wall seconds per arm, peak device memory and
the card's name and power limit (nvidia-smi). Writes every number to
`--out` as JSON. `--from_logs` rebuilds the table from earlier logs
without training. Exits 0 whether the gates are met or missed; non-zero if
a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(ROOT, "scripts", "ssl_ablation_torch.py")
# the TPU's run of scripts/exp_ssl_ablation.py at its defaults, JAX float32
# (bench_results/r04_queue_overnight.json; seed 1337 from round 3, whose
# record has no test Jaccard)
TPU = {
    1337: {"sup": dict(best_val_dice=0.5399, test_dice=0.4624, test_jaccard=None,
                       test_hd95=29.06, test_asd=5.77),
           "dycon": dict(best_val_dice=0.584, test_dice=0.5002, test_jaccard=None,
                         test_hd95=24.47, test_asd=2.99)},
    2337: {"sup": dict(best_val_dice=0.5654, test_dice=0.5316, test_jaccard=0.3771,
                       test_hd95=23.6, test_asd=1.66),
           "dycon": dict(best_val_dice=0.6119, test_dice=0.5133, test_jaccard=0.3639,
                         test_hd95=23.71, test_asd=2.34)},
    3337: {"sup": dict(best_val_dice=0.5543, test_dice=0.4855, test_jaccard=0.353,
                       test_hd95=26.98, test_asd=7.28),
           "dycon": dict(best_val_dice=0.6158, test_dice=0.4892, test_jaccard=0.36,
                         test_hd95=25.68, test_asd=6.39)},
}
ARMS = ("sup", "dycon")
GAIN_MIN, MEAN_ATOL = 0.025, 0.03
TEST_KEYS = ("test_dice", "test_jaccard", "test_hd95", "test_asd")


def parse_log(path: str) -> dict:
    """The last JSON line of each arm in one driver log."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith('{"arm"'):
                rec = json.loads(line)
                out[rec.pop("arm")] = rec
    return out


def gates(table: dict) -> dict:
    """Gates (a)-(c) over {seed: {arm: results}}."""
    seeds = sorted(table)
    gain = {s: table[s]["dycon"]["best_val_dice"] - table[s]["sup"]["best_val_dice"]
            for s in seeds}
    mean = {arm: statistics.mean(table[s][arm]["best_val_dice"] for s in seeds) for arm in ARMS}
    tpu_mean = {arm: statistics.mean(TPU[s][arm]["best_val_dice"] for s in seeds) for arm in ARMS}
    return {
        "a_dycon_above_sup_every_seed": all(g > 0 for g in gain.values()),
        "b_mean_gain_at_least_0.025": statistics.mean(gain.values()) >= GAIN_MIN,
        "c_arm_means_within_0.03_of_tpu": all(abs(mean[a] - tpu_mean[a]) <= MEAN_ATOL
                                              for a in ARMS),
        "gain": gain, "mean_gain": statistics.mean(gain.values()), "mean": mean,
        "tpu_mean": tpu_mean,
        "tpu_mean_gain": statistics.mean(TPU[s]["dycon"]["best_val_dice"]
                                         - TPU[s]["sup"]["best_val_dice"] for s in seeds),
    }


def _fmt(v, digits=4):
    return "-" if v is None else f"{v:.{digits}f}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=sorted(TPU))
    ap.add_argument("--logs", default=os.path.join(ROOT, "runs", "ablation_logs"))
    ap.add_argument("--work", default=os.path.join(ROOT, "runs", "ablation_runs"))
    ap.add_argument("--root", default=os.path.join(ROOT, "runs", "hard_pancreas"))
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "ablation_table.json"))
    ap.add_argument("--from_logs", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.logs, exist_ok=True)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
            if shutil.which("nvidia-smi") else "no nvidia-smi here")
    print(card, flush=True)

    table = {}
    for seed in args.seeds:
        log = os.path.join(args.logs, f"seed{seed}.log")
        if not args.from_logs:
            with open(log, "w") as f:
                rc = subprocess.run([sys.executable, DRIVER, "--seed", str(seed), "--root",
                                     args.root, "--work", os.path.join(args.work, f"s{seed}")],
                                    stdout=f, stderr=subprocess.STDOUT).returncode
            if rc:
                print(f"seed {seed}: the driver exited {rc}; its log is {log}", flush=True)
                return rc
        table[seed] = parse_log(log)
        print(f"seed {seed}: " + json.dumps(table[seed]), flush=True)

    print("| seed | sup best val (TPU) | DyCON best val (TPU) | gain (TPU) |")
    print("|---|---|---|---|")
    for seed in args.seeds:
        port, tpu = table[seed], TPU[seed]
        print(f"| {seed} | {_fmt(port['sup']['best_val_dice'])} "
              f"({_fmt(tpu['sup']['best_val_dice'])}) | {_fmt(port['dycon']['best_val_dice'])} "
              f"({_fmt(tpu['dycon']['best_val_dice'])}) | "
              f"{port['dycon']['best_val_dice'] - port['sup']['best_val_dice']:+.4f} "
              f"({tpu['dycon']['best_val_dice'] - tpu['sup']['best_val_dice']:+.4f}) |")
    g = gates(table)
    print(f"| mean | {_fmt(g['mean']['sup'])} ({_fmt(g['tpu_mean']['sup'])}) | "
          f"{_fmt(g['mean']['dycon'])} ({_fmt(g['tpu_mean']['dycon'])}) | "
          f"{g['mean_gain']:+.4f} ({g['tpu_mean_gain']:+.4f}) |")
    for key in ("a_dycon_above_sup_every_seed", "b_mean_gain_at_least_0.025",
                "c_arm_means_within_0.03_of_tpu"):
        print(f"gate {key}: {'met' if g[key] else 'missed'}")
    print("test metrics (port / TPU), not gated; ms/step p50, wall s, peak GiB per arm:")
    for seed in args.seeds:
        for arm in ARMS:
            port, tpu = table[seed][arm], TPU[seed][arm]
            cells = " ".join(f"{k.removeprefix('test_')} {_fmt(port.get(k))} / {_fmt(tpu[k])}"
                             for k in TEST_KEYS)
            print(f"  {seed} {arm}: {cells}; {_fmt(port.get('step_ms_p50'), 3)} ms, "
                  f"{_fmt(port.get('wall_s'), 1)} s, {_fmt(port.get('peak_gib'), 3)} GiB")
    with open(args.out, "w") as f:
        json.dump({"card": card, "table": table, "tpu": TPU, "gates": g}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
