#!/usr/bin/env python3
"""Time, on one GPU, the training ops whose backward the deterministic mode
(torch.use_deterministic_algorithms) changes, with the mode off and on,
and check whether their gradients are bit-identical across reruns.

    python3 scripts/time_determinism_ops.py [--reps 20] [--reruns 5]

Ops, at the shapes the training paths give them (float32, inputs standard
normal from a seed):
  * the projection head's corner-aligned trilinear upsample of the
    bottleneck (x2 per axis) and ASPP's pooled branch (1x1x1 -> the
    bottleneck): the port's (ops/resize.py: autograd through index_select,
    whose backward is index_add_, float atomics on CUDA and a sorted
    index_put_ under the mode), and a design the port does not use, an
    autograd Function whose backward contracts the cotangent with the dense
    (out, in) matrix of the lerp's weights (one matmul per axis, no atomics);
  * the cross-entropy over the labeled half of a batch, two classes: the
    port's (ops/losses.py: the label picked by a where over the classes, an
    elementwise backward) and through gather (whose backward is a
    scatter_add_, a sorted index_put_ under the mode).
One JSON line per op, variant and mode: ms per forward + backward by CUDA
events over --reps after one warm-up, whether --reruns backward passes gave
bit-identical gradients (and the largest difference between them), and the
largest difference from the port's gradient with the mode on. The last line
holds the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, input (B, D1, D2, D3, C), output spatial): the UNet3D's bottleneck
# at the Pancreas (112x112x96), BraTS (96^3), ISLES (96x96x64) and SSL
# ablation (64x64x48, B 4) patches, x2 by the head; ASPP's pooled branch
RESIZES = [
    ("head_pancreas", (8, 7, 7, 6, 256), (14, 14, 12)),
    ("head_brats", (8, 6, 6, 6, 256), (12, 12, 12)),
    ("head_isles", (8, 6, 6, 4, 256), (12, 12, 8)),
    ("head_ablation", (4, 4, 4, 3, 256), (8, 8, 6)),
    ("aspp_pool_pancreas", (8, 1, 1, 1, 256), (7, 7, 6)),
]
# (name, logits of the labeled half): Pancreas (4 of 8 at 112x112x96), BraTS
# and ISLES (4 of 8 at 96^3 and 96x96x64), the ablation (2 of 4 at 64x64x48)
GATHERS = [
    ("ce_pancreas", (4, 112, 112, 96, 2)),
    ("ce_brats", (4, 96, 96, 96, 2)),
    ("ce_isles", (4, 96, 96, 64, 2)),
    ("ce_ablation", (2, 64, 64, 48, 2)),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--reruns", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from chip_smoke import _time_ms
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.ops import losses, resize

    device = resolve_device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)

    class MatmulLerp(torch.autograd.Function):
        """ops/resize.py:_axis_lerp's forward; its backward one matmul with
        the (out, in) weight matrix of the lerp."""

        @staticmethod
        def forward(ctx, x, axis, out_size):
            y = resize._axis_lerp(x, axis, out_size, True)
            n_in = x.shape[axis]
            scale = (n_in - 1) / (out_size - 1) if out_size > 1 else 0.0
            src = torch.arange(out_size, dtype=torch.float32, device=x.device) * scale
            lo = src.floor().to(torch.int64).clamp(0, n_in - 1)
            hi = (lo + 1).clamp(0, n_in - 1)
            w = (src - lo.to(torch.float32))[:, None]
            cols = torch.arange(n_in, device=x.device)
            ctx.m = (1.0 - w) * (lo[:, None] == cols) + w * (hi[:, None] == cols)
            ctx.axis = axis
            return y

        @staticmethod
        def backward(ctx, g):
            dx = torch.tensordot(g, ctx.m, dims=([ctx.axis], [0])).movedim(-1, ctx.axis)
            return dx.contiguous(), None, None

    def matmul_resize(x, out_spatial):
        for axis, size in zip((1, 2, 3), out_spatial):
            x = x if x.shape[axis] == size else MatmulLerp.apply(x, axis, size)
        return x

    def gather_ce(logits, labels):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, labels[..., None]).mean()

    def measure(name, variant, fn, x, g, reference=None):
        """fn(x) forward + backward against cotangent g, off and on."""
        rows = {}
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)

            def fwd_bwd():
                return torch.autograd.grad(fn(x), x, g)[0]

            ms = _time_ms(torch, fwd_bwd, reps=args.reps)
            grads = [fwd_bwd() for _ in range(args.reruns)]
            spread = max(float((d - grads[0]).abs().max()) for d in grads)
            row = dict(op=name, variant=variant, mode="on" if mode else "off", ms=ms,
                       bit_identical=all(torch.equal(d, grads[0]) for d in grads),
                       max_rerun_diff=spread)
            if reference is not None:
                row["max_diff_from_port"] = float((grads[0] - reference).abs().max())
            print(json.dumps(row), flush=True)
            rows[row["mode"]] = grads[0]
        torch.use_deterministic_algorithms(False)
        return rows["on"]

    for name, shape, out in RESIZES:
        x = torch.randn(shape, device=device, generator=gen).requires_grad_(True)
        g = torch.randn(shape[0], *out, shape[-1], device=device, generator=gen)
        port = measure(name, "port", lambda t: resize.trilinear_resize(t, out, True), x, g)
        measure(name, "matmul", lambda t: matmul_resize(t, out), x, g, port)
    for name, shape in GATHERS:
        x = torch.randn(shape, device=device, generator=gen).requires_grad_(True)
        label = torch.randint(0, shape[-1], shape[:-1], device=device, generator=gen)
        g = torch.ones((), device=device)
        port = measure(name, "port", lambda t: losses.cross_entropy_loss(t, label), x, g)
        measure(name, "gather", lambda t: gather_ce(t, label), x, g, port)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
