#!/usr/bin/env python3
"""Time K2, the fused FeCL (`ops/fecl_fused.py`: fecl_fwd, fecl_bwd), on one
GPU at the ISLES defaults (B 8, N 9216, D 256, teacher on: chip_smoke.py's
inputs from its seed).

    python3 scripts/time_k2.py [--reps 5] [--baseline FILE.cu] [--variants] [--tag NAME]

Prints one JSON line per timed run: ms per call by CUDA events over --reps
calls after one warm-up, TFLOP/s on K2's own B x N x N x D products (4
forward, 4 backward) and on the JAX algorithm's (3, 5), and the share of
the 3xTF32 bound of the latter; the last line holds the card's name and
power limit. With --baseline another K2 source (for example the parent's
fecl_fused.cu, from `git archive` into a gitignored directory) is built as
a library of its own and timed in turns with this checkout's: baseline,
this, this, baseline; its outputs are compared with this checkout's
(max difference over max |value|). With --variants the design variants
of the source (its K2_* macros, which the port's own build never sets) are
built too, each as a one-line source that defines them and includes
fecl_fused.cu, and timed in turns with it, twice over; a `kernels` line
per run then gives the device ms of each of K2's four kernels (one
forward and one backward under torch.profiler). With PYTHONPATH=<other
checkout> the package, K2 among it, comes from that checkout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_common import device_ms_by_category  # noqa: E402  (beside this script)

VARIANTS = {  # name: K2_* macros (ops/csrc/fecl_fused.cu's header)
    "dk16": ("K2_DK=16",), "s2": ("K2_STAGES=2",), "one-pass": ("K2_ONE_PASS",),
    "no-split": ("K2_NO_SPLIT",), "no-copy": ("K2_NO_COPY",), "no-mma": ("K2_NO_MMA",),
    "no-epilogue": ("K2_NO_EPILOGUE",), "bare": ("K2_NO_COPY", "K2_NO_MMA", "K2_NO_SPLIT"),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", default=None, help="another K2 source (.cu) to time in turns")
    ap.add_argument("--variants", action="store_true", help="also time the design variants")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    import torch

    from chip_smoke import PEAKS, SEED, _bound, _isles_fecl_inputs, _time_ms
    from dycon_paper_replication_tpu_torch.config import resolve_device
    from dycon_paper_replication_tpu_torch.ops import _build
    from dycon_paper_replication_tpu_torch.ops import fecl_fused as ff

    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    feat, mask, tfeat = _isles_fecl_inputs(torch, device, gen)
    b, n, d = feat.shape
    o = ff.FeclOptions(0.6, 2.0, True, 1.3, 0.3, 1.0, 512)

    def wrappers(source):
        fwd, bwd = ff.FeclForward(), ff.FeclBackward()
        with mock.patch.object(ff, "SOURCE", Path(source)):
            fwd._kernel()
            bwd._kernel()
        return fwd, bwd

    kernels = {"this": wrappers(ff.SOURCE)}
    order = ["this"]
    if args.baseline:
        kernels["baseline"] = wrappers(args.baseline)
        order = ["baseline", "this", "this", "baseline"]
    if args.variants:
        # one source per variant: its macros, then fecl_fused.cu (whose hash
        # it carries, so an edit of the source rebuilds it)
        digest = hashlib.sha256(Path(ff.SOURCE).read_bytes()).hexdigest()[:16]
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = {}
        for name, macros in VARIANTS.items():
            src = _build.BUILD_DIR / f"k2_variant_{name}.cu"
            src.write_text(f"// fecl_fused.cu {digest}\n"
                           + "".join(f"#define {m.replace('=', ' ')}\n" for m in macros)
                           + f'#include "{Path(ff.SOURCE).resolve()}"\n')
            sources[name] = src
        for src, log in _build.build(*sources.values()).items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {src.name}:", line.strip())
        kernels.update({name: wrappers(src) for name, src in sources.items()})
        order = (order + list(VARIANTS)) * 2

    fwd, bwd = kernels["this"]
    res = fwd.launch(feat, mask, tfeat, o)
    col_max, s_all, rho = res[0], res[1], res[4]
    a_all = (ff._row_weights(mask) / (b * n)).contiguous()
    g_cross = 1.0 / (float(res[6].sum()) + ff.EPS)

    def backward(k):
        return k.launch(feat, mask, tfeat, col_max, s_all, rho, a_all, g_cross, o)

    if args.baseline:
        base_fwd, base_bwd = kernels["baseline"]
        res_b = base_fwd.launch(feat, mask, tfeat, o)
        names = ("col_max", "S", "row_sum", "row_sum_unf", "rho", "c_sum", "c_cnt", "dF")
        got = (*res, backward(bwd))
        ref = (*res_b, backward(base_bwd))
        print(json.dumps(dict(tag=args.tag, vs_baseline={
            k: (x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
            for k, x, y in zip(names, got, ref)})), flush=True)

    product = 2 * b * n * n * d
    total = {}
    for label in order:
        fwd, bwd = kernels[label]
        for name, fn, jax_products, own, nbytes in (
                ("fwd", lambda: fwd.launch(feat, mask, tfeat, o), 3, 4,
                 4 * (2 * b * n * d + 8 * b * n)),
                ("bwd", lambda: backward(bwd), 5, 4, 4 * (3 * b * n * d + 5 * b * n))):
            ms = _time_ms(torch, fn, reps=args.reps)
            bound = _bound(jax_products * product, nbytes, peaks)
            total.setdefault((label, name), []).append(ms)
            # a baseline's own product count is its own: rated on the JAX algorithm's only
            own_rate = {} if label == "baseline" else dict(own_tflops=own * product / ms / 1e9)
            print(json.dumps(dict(tag=args.tag, kernel=label, direction=name, ms=ms, **own_rate,
                                  jax_tflops=jax_products * product / ms / 1e9,
                                  tf32x3_bound_ms=bound["tf32x3_bound_ms"],
                                  tf32x3_share=bound["tf32x3_bound_ms"] / ms)), flush=True)
        if args.variants:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fwd.launch(feat, mask, tfeat, o)
                backward(bwd)
                torch.cuda.synchronize()
            _, per_kernel = device_ms_by_category(prof, 1)
            print(json.dumps(dict(tag=args.tag, kernel=label, kernels={
                k.split("fecl_kernel")[-1][:16]: ms for ms, _, k in per_kernel
                if "fecl" in k})), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(tag=args.tag, shape=[b, n, d], card=smi, source=str(ff.SOURCE),
                          baseline=args.baseline,
                          mean_ms={f"{k[0]} {k[1]}": sum(v) / len(v) for k, v in total.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
