#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout and drives the port's main
path, Pancreas sliding-window evaluation of a full-width UNet3D checkpoint,
once through its CLI. Phases, each timed on its own line:

  1. the card's name and power limit (nvidia-smi);
  2. build K1 (ops/csrc/folded_conv3.cu) with nvcc;
  3. K1 against its plain F.conv3d version at the 8 full-width shapes one
     patch forward gives it (patch 96^3, B = PATCH_BATCH), float32 with TF32
     off, tolerance 1e-4 * max|plain|; its time beside the plain version's,
     one cuDNN conv call's (library_ms) and the FLOP/byte bound;
  4. the folded UNet3D (through K1) against the plain UNet3D on one patch
     batch with the same weights, tolerance 1e-4 * max|plain|;
  5. end to end: seeded weights in the JAX layout through the weight mapper
     into a checkpoint, one synthetic (144, 144, 112) volume written with
     numpy (80 patches at stride 16/4, all origins even so the folded path
     runs), the port's test_pancreas CLI on it with the K1 launch count set
     to 0 before and read after (it must be 8 per forward chunk), and its
     label map against the plain engine's (>= 99.99 % of voxels agree);
  6. a `{"kernels": [...]}` line, then `{"ok": true, "device": {...}}` last.

Any failed check raises and the process exits non-zero. It exits non-zero
without a result when CUDA is unavailable, and when run outside the
repository (the port's package cannot be imported). It writes only under a
temporary directory, apart from the kernel build directory of the package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

PATCH = (96, 96, 96)
STRIDE_XY, STRIDE_Z = 16, 4
PATCH_BATCH = 4
VOLUME = (144, 144, 112)
SEED = 0
REPS = 5
# published dense peaks: (float32 FLOP/s on the CUDA cores, HBM bytes/s)
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60e12, 3.9e12),
         "H200": (67e12, 4.8e12), "H100": (67e12, 3.35e12)}
# (layer, fold grid G of the input, L_in, L_out, to_phase) for one patch forward
K1_SHAPES = [
    ("conv1.conv1", 48, 8, 128, 1), ("conv1.conv2", 49, 128, 128, 0),
    ("conv2.conv1", 24, 128, 256, 1), ("conv2.conv2", 25, 256, 256, 0),
    ("up_concat2.conv1", 24, 768, 256, 1), ("up_concat2.conv2", 25, 256, 256, 0),
    ("up_concat1.conv1", 48, 384, 128, 1), ("up_concat1.conv2", 49, 128, 128, 0),
]


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _time_ms(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.cli import test_pancreas
    from dycon_paper_replication_tpu_torch.config import make_config, resolve_device
    from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume, write_case
    from dycon_paper_replication_tpu_torch.eval import SlidingWindowInference, compute_origins
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops import _build
    from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
        SOURCE, folded_conv3, folded_conv3_plain)
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    t_all = time.perf_counter()
    device = resolve_device("cuda")  # also turns TF32 off
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    peak_flops, peak_bw = next(v for k, v in PEAKS.items() if k in kind) \
        if any(k in kind for k in PEAKS) else PEAKS["H100"]
    print(f"bound peaks: {peak_flops / 1e12} TFLOP/s float32, {peak_bw / 1e12} TB/s")
    _phase("card", t0)

    # 2. build
    t0 = time.perf_counter()
    log = _build.build(SOURCE)[SOURCE]
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("ptxas:", line.strip())
    print(f"build_s {time.perf_counter() - t0:.3f}")
    _phase("build", t0)

    # 3. K1 against its plain version at the full-width shapes
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for layer, g, lin, lout, to_phase in K1_SHAPES:
        x = torch.randn(PATCH_BATCH, g, g, g, lin, device=device, generator=gen)
        wf = torch.randn(2, 2, 2, lin, lout, device=device, generator=gen) / math.sqrt(8 * lin)
        y = folded_conv3.launch(x, wf, to_phase=to_phase)
        want = folded_conv3_plain(x, wf, to_phase=to_phase)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        scale = want.abs().max().item()
        _check(bool(torch.isfinite(y).all()) and err <= 1e-4 * scale,
               f"K1 {layer}: max abs err {err} > 1e-4 * {scale}")
        xn, wn = x.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2).contiguous()
        pad = 1 if to_phase == 1 else 0
        ms = _time_ms(torch, lambda: folded_conv3.launch(x, wf, to_phase=to_phase))
        plain_ms = _time_ms(torch, lambda: folded_conv3_plain(x, wf, to_phase=to_phase))
        library_ms = _time_ms(torch, lambda: F.conv3d(xn, wn, padding=pad))
        q = g + (1 if to_phase == 1 else -1)
        flops = 2 * PATCH_BATCH * q ** 3 * lin * lout * 8
        nbytes = 4 * (x.numel() + wf.numel() + y.numel())
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        row = dict(layer=layer, x=list(x.shape), wf=list(wf.shape), to_phase=to_phase,
                   max_abs_err=err, max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ops_ms=t_ops, bytes_ms=t_bytes, tflops=flops / ms / 1e9)
        rows.append(row)
        print("k1", json.dumps(row), flush=True)
        del x, wf, y, want, xn, wn
    _phase("kernels", t0)

    # 4. full-width model: folded (through K1) against plain
    t0 = time.perf_counter()
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=SEED)
    sd = weights.jax_tree_to_state_dict(params, state)
    nets = {}
    for layout in ("folded", "NDHWC"):
        nets[layout] = UNet3D(UNet3DConfig(layout=layout)).to(device).eval()
        nets[layout].load_state_dict(sd)
    x = torch.rand(PATCH_BATCH, *PATCH, 1, device=device, generator=gen)
    with torch.inference_mode():
        _, seg_f, feat_f = nets["folded"](x)
        _, seg_p, feat_p = nets["NDHWC"](x)
    torch.cuda.synchronize()
    for name, a, b in (("seg", seg_f, seg_p), ("features", feat_f, feat_p)):
        diff = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"model {name}: max abs diff folded vs plain {diff} (max |plain| {scale})")
        _check(bool(torch.isfinite(a).all()) and diff <= 1e-4 * scale,
               f"folded model {name} differs from plain by {diff}")
    _check(tuple(seg_f.shape) == (PATCH_BATCH, *PATCH, 2), f"seg shape {tuple(seg_f.shape)}")
    del x, seg_f, seg_p, feat_f, feat_p
    _phase("model", t0)

    # 5. end to end through the CLI
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "Pancreas")
        os.makedirs(os.path.join(root, "Pancreas_data"))
        image, label = _ellipsoid_volume(np.random.default_rng(SEED), VOLUME)
        write_case(os.path.join(root, "Pancreas_data", "PANCREAS_t0000.npz"), image, label)
        with open(os.path.join(root, "test1.list"), "w") as f:
            f.write("PANCREAS_t0000.npz\n")
        runs = os.path.join(tmp, "runs")
        snapshot = make_config("pancreas", snapshot_root=runs).snapshot_path()
        checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "unet_3D"),
                                   nets["folded"])
        origins = compute_origins(VOLUME, PATCH, STRIDE_XY, STRIDE_Z)
        n_chunks = math.ceil(len(origins) / PATCH_BATCH)
        _check(len(origins) == 80 and not (origins % 2).any(), f"{len(origins)} origins")

        argv = ["--root_path", root, "--snapshot_root", runs, "--device", "cuda",
                "--patch_batch", str(PATCH_BATCH)]
        folded_conv3.launches = 0
        t_cli = time.perf_counter()
        avg = test_pancreas.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t_cli
        launches = folded_conv3.launches
        print(f"e2e: {len(origins)} patches, {n_chunks} chunks, K1 launches {launches}, "
              f"cli wall {cli_s:.3f} s, {1.0 / cli_s:.4f} vols/s")
        _check(launches == 8 * n_chunks, f"K1 launches {launches} != 8 * {n_chunks}")
        _check(len(avg) == 4 and all(math.isfinite(v) for v in avg), f"metrics {avg}")

        # the folded engine's label map against the plain engine's
        sw_f = SlidingWindowInference(nets["folded"], PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
        sw_p = SlidingWindowInference(nets["NDHWC"], PATCH, STRIDE_XY, STRIDE_Z, PATCH_BATCH)
        t_sw = time.perf_counter()
        label_f, score_f = sw_f(image)
        torch.cuda.synchronize()
        sw_s = time.perf_counter() - t_sw
        t_sw = time.perf_counter()
        label_p, score_p = sw_p(image)
        torch.cuda.synchronize()
        sw_plain_s = time.perf_counter() - t_sw
        agree = float((label_f == label_p).mean())
        print(f"sliding window: folded {sw_s:.3f} s ({1.0 / sw_s:.4f} vols/s), plain "
              f"{sw_plain_s:.3f} s; label agreement {agree:.7f}; max |score diff| "
              f"{float(np.abs(score_f - score_p).max())}; foreground {int(label_f.sum())} voxels")
        _check(label_f.shape == VOLUME and np.isfinite(score_f).all(), "folded engine output")
        _check(agree >= 0.9999, f"label agreement {agree} < 0.9999")
    _phase("e2e", t0)

    kernels = [dict(
        name="folded_conv3", route="cuda",
        source="dycon_paper_replication_tpu_torch/ops/csrc/folded_conv3.cu",
        replaces="dycon_paper_replication_tpu/ops/folded_conv_pallas.py:107 (folded_conv3_pallas)",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_err=max(r["max_abs_err"] for r in rows),
        # one patch-batch forward: the 8 shapes once each
        ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by=("operations" if sum(r["ops_ms"] for r in rows) >= sum(r["bytes_ms"] for r in rows)
                  else "bytes"),
        library_ms=sum(r["library_ms"] for r in rows),
        shapes=rows,
    )]
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
