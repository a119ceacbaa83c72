#!/usr/bin/env python3
"""The JAX package's trained Pancreas checkpoint through the port's test CLI
on the GPU, over the canonical test volumes, in float32 and bf16.

    python3 scripts/eval_trained.py [--volumes 20] [--out FILE.json]

Runs chip_smoke.py's phase trained_eval with `--volumes` of the 20 volumes
of test1.list (the smoke runs the first 4): the committed
trained/pancreas_unet3d_r05_best.pt at the best-model path of
`cli.test_pancreas --max_iterations 20000`, the canonical tree regenerated
by the port's make_pancreas, the test CLI with --compute_dtype float32 and
then bfloat16 (folded, patch 96^3, stride 16/4), and the plain float32
engine; K1 is built before the first run, so vols/s holds no nvcc time. Prints the phase's lines, then a table of each volume's Dice,
Jaccard, HD95 and ASD in both dtypes beside the TPU log's
(bench_results/r05_canonical20k_test_eval.log), the means, the share of
voxels whose label differs between bf16 and float32, the host seconds a
volume and vols/s, and the card's name and power limit (nvidia-smi); writes
every number to `--out` as JSON. Fails where the phase's gates fail, after
printing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "trained_eval.json"))
    args = ap.parse_args()

    import torch

    import chip_smoke
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.ops import _build
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import SOURCE

    device = resolve_device("cuda")
    _build.build(SOURCE)  # K1 (float32 and bf16): nvcc before the timed CLI runs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        result = chip_smoke.phase_trained_eval(torch, device, tmp, n_volumes=args.volumes,
                                               check=False)
    print(f"{'volume':<20} {'dtype':<9} {'Dice':>8} {'Jaccard':>8} {'HD95':>8} {'ASD':>8}")
    for row in result["rows"]:
        for name in ("log", "float32", "bfloat16"):
            d, j, h, a = row[name]
            print(f"{row['volume']:<20} {name:<9} {d:>8.5f} {j:>8.5f} {h:>8.5f} {a:>8.5f}")
    for name, mean in (("log", result["log_mean"]), *result["mean"].items()):
        print(f"{'mean':<20} {name:<9} " + " ".join(f"{v:>8.5f}" for v in mean))
    print(f"bf16 against float32: labels differ at {result['bf16_vs_f32_scored']} of voxels "
          f"as scored, {result['bf16_vs_f32_raw']} before the largest component; host "
          f"scoring {result['host_s_per_volume']} s a volume; vols/s "
          f"{result['vols_per_s']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(result, card=smi), f, indent=1)
    print(smi)
    chip_smoke.check_trained_eval(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
