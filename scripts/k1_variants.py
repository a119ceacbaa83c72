#!/usr/bin/env python3
"""What holds K1 back, and what its arithmetic buys: variants of
`ops/csrc/folded_conv3.cu` compiled from the same source by -D flags in
this script's own build (the port's build defines none of them), timed and
checked at the 8 convs of one Pancreas training forward on one GPU.

    python3 scripts/k1_variants.py [--reps 10] [--out DIR] [--baseline FILE.cu]
        [--dtype float32|bf16]

Variants:
  as-is      the source;
  one-pass   K1_ONE_PASS: hi_a*hi_b only, one TF32 pass (a diagnostic: what
             the tensor-core passes cost; fails the gate);
  no-reuse   K1_NO_REUSE: each tap stages its own 128 input rows and its
             own wf slice, one tap per stage, so an input voxel crosses
             into shared memory 8 times per output tile (the traffic of a
             per-tap gather);
  tap-sums   K1_TAP_SUMS: a fresh float32 sum per tap and 16 x 8 piece
             instead of one per stage of 8 taps (more float adds, a smaller
             rms error);
  running    K1_RUNNING_SUM: every product straight into the running float32
             sum, without fresh sums;
  baseline   (with --baseline) another K1 source with the same C entry,
             e.g. an older checkout's, built with the same flags.
With --dtype bf16, the bf16 instance (K1-bf16: its wgmma instance at every
shape but conv1.conv1) on bf16 operands, against a float64 conv of the same
bf16 values with the smoke's bf16 gate max(2^-8 max|ref|, 2 x the bf16 plain
version's error), and its variants:
  as-is       the source;
  direct-store  K1W_DIRECT_STORE: each thread stores its sums to y itself
              (4 bytes a store) instead of the tile's two TMA stores from
              shared memory;
  no-mma      K1W_NO_MMA: every wgmma left out (a diagnostic: the TMA
              loads, barriers, ldmatrix and stores alone; fails the gate);
  no-store    K1W_NO_STORE: the epilogue's stores left out (a diagnostic:
              what writing y costs; fails the gate);
  baseline    as above, with the bf16 entry's C signature of this tree.
The accuracy and step sections below are float32's only.
Per variant and shape one JSON line: ms (CUDA events over --reps launches
after a warm-up), TFLOP/s, the max error against the float32 plain version
and K1's gate 1e-4 max|plain|; then each variant's sum. Variants run in
turn, the whole set twice. Then accuracy: per shape (at B 2) the rms, max
and mean error against a float64 conv, of each variant and of cuDNN's
float32 conv (`accuracy` lines); and per variant the card-against-CPU train
step of train/device_check.py with that variant as K1 (`step` lines): the
leaves beyond tolerance, the nearest to it per group, and how far the
variant moves the projection head's pre-ReLU value nearest its kink on the
CPU (the case's most fragile point). Last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {"as-is": (), "one-pass": ("-DK1_ONE_PASS",), "no-reuse": ("-DK1_NO_REUSE",),
            "tap-sums": ("-DK1_TAP_SUMS",), "running": ("-DK1_RUNNING_SUM",)}
BF16_VARIANTS = {"as-is": (), "direct-store": ("-DK1W_DIRECT_STORE",),
                 "no-mma": ("-DK1W_NO_MMA",), "no-store": ("-DK1W_NO_STORE",)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="where the variant libraries go (default: the port's build directory)")
    ap.add_argument("--baseline", default=None,
                    help="another K1 source (with its headers beside it) to time as 'baseline'")
    ap.add_argument("--dtype", choices=("float32", "bf16"), default="float32")
    args = ap.parse_args()
    bf16 = args.dtype == "bf16"

    import torch

    from chip_smoke import TRAIN_BATCH, TRAIN_SHAPES, _time_ms
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.ops import _build
    from dycon_paper_replication_tpu_torch.ops import folded_conv_cuda as fc

    device = resolve_device("cuda")
    args.out = args.out or str(_build.BUILD_DIR / "k1_variants")
    os.makedirs(args.out, exist_ok=True)
    builds = {name: (str(fc.SOURCE), flags)
              for name, flags in (BF16_VARIANTS if bf16 else VARIANTS).items()}
    if args.baseline:
        builds["baseline"] = (args.baseline, ())
    procs = {}
    for name, (src, flags) in builds.items():
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
             os.path.join(args.out, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps(dict(variant=name, ptxas=[line.strip() for line in log.splitlines()
                                                   if "registers" in line or "spill" in line])))
        fn = getattr(ctypes.CDLL(os.path.abspath(os.path.join(args.out, f"{name}.so"))),
                     "dycon_folded_conv3_bf16" if bf16 else "dycon_folded_conv3_f32")
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (11 if bf16 else 7)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        kernels[name] = fc.FoldedConv3()
        kernels[name]._fns[torch.bfloat16 if bf16 else torch.float32] = fn

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for layer, g, lin, lout, to_phase in TRAIN_SHAPES:
        x = torch.randn(TRAIN_BATCH, *g, lin, device=device, generator=gen)
        wf = torch.randn(2, 2, 2, lin, lout, device=device, generator=gen) / math.sqrt(8 * lin)
        if bf16:
            x, wf = x.to(torch.bfloat16), wf.to(torch.bfloat16)
            want = fc.folded_conv3_plain(x.double(), wf.double(), to_phase=to_phase)
            plain = fc.folded_conv3_plain(x, wf, to_phase=to_phase).double()
            gate = max(2.0 ** -8 * want.abs().max().item(),
                       2 * (plain - want).abs().max().item())
            del plain
        else:
            want = fc.folded_conv3_plain(x, wf, to_phase=to_phase)
            gate = 1e-4 * want.abs().max().item()
        q = want.shape[1:4]
        cases.append((layer, x, wf, to_phase, want, gate,
                      2 * TRAIN_BATCH * math.prod(q) * lin * lout * 8))
    for rnd in range(2):
        for name, k in kernels.items():
            total = 0.0
            for layer, x, wf, to_phase, want, gate, flops in cases:
                err = (k.launch(x, wf, to_phase=to_phase).to(want.dtype) - want
                       ).abs().max().item()
                ms = _time_ms(torch, lambda: k.launch(x, wf, to_phase=to_phase), reps=args.reps)
                total += ms
                print(json.dumps(dict(round=rnd, variant=name, layer=layer, ms=ms,
                                      tflops=flops / ms / 1e9, max_abs_err=err, gate=gate,
                                      meets_gate=err <= gate)), flush=True)
            print(json.dumps(dict(round=rnd, variant=name, sum_ms=total)), flush=True)
    del cases
    if not bf16:
        accuracy(torch, device, fc, kernels, TRAIN_SHAPES)
        step_check(torch, device, fc, kernels)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


def accuracy(torch, device, fc, kernels, shapes, batch=2):
    """(rms, max, mean) error against a float64 conv per shape: each
    variant's and cuDNN's float32 conv's (TF32 off)."""
    gen = torch.Generator(device=device).manual_seed(1)
    for layer, g, lin, lout, to_phase in shapes:
        x = torch.randn(batch, *g, lin, device=device, generator=gen)
        wf = torch.randn(2, 2, 2, lin, lout, device=device, generator=gen) / math.sqrt(8 * lin)
        ref = fc.folded_conv3_plain(x.double(), wf.double(), to_phase=to_phase)

        def err(y):
            e = y.double() - ref
            return [e.square().mean().sqrt().item(), e.abs().max().item(), e.mean().item()]

        row = dict(layer=layer, batch=batch, max_abs_ref=ref.abs().max().item(),
                   cudnn=err(fc.folded_conv3_plain(x, wf, to_phase=to_phase)))
        for name, k in kernels.items():
            row[name] = err(k.launch(x, wf, to_phase=to_phase))
        print("accuracy", json.dumps(row), flush=True)
        del x, wf, ref


def step_check(torch, device, fc, kernels):
    """train/device_check.py's card-against-CPU step with each variant as K1
    (forward and dx)."""
    from dycon_paper_replication_tpu_torch.train import device_check as dc

    state = dc.initial_state(0)
    batch, _ = dc.make_inputs(0)
    image = torch.from_numpy(batch["image"])

    def pre_relu(dev):
        net = dc.state_on(state, dev).student.train()
        out = []
        net.projection.bn1.register_forward_hook(lambda m, i, o: out.append(o.detach().cpu()))
        net(image.to(dev))
        return out[0].flatten()

    ref = pre_relu(torch.device("cpu"))
    i = ref.abs().argmin()
    f32 = torch.float32
    fwd, dx = fc.folded_conv3._kernel(f32), fc.folded_conv3_dx._kernel(f32)
    for name, k in kernels.items():
        fc.folded_conv3._fns[f32] = fc.folded_conv3_dx._fns[f32] = k._fns[f32]
        moved = (pre_relu(device)[i] - ref[i]).item()
        diffs, _, worst = dc.check_step(device)
        print("step", json.dumps(dict(variant=name, kink_margin_cpu=ref[i].item(),
                                      moved_by_card=moved, leaves_beyond_tolerance=len(diffs),
                                      worst=worst)), flush=True)
    fc.folded_conv3._fns[f32], fc.folded_conv3_dx._fns[f32] = fwd, dx


if __name__ == "__main__":
    sys.exit(main())
