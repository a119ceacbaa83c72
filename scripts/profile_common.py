"""Device time from torch.profiler, grouped by kernel, for the profile
scripts beside this file."""

from __future__ import annotations


def category(name: str) -> str:
    """k1 (K1 forward and dx), k1_dw (K1-dW and its split-K sum), k2 (the
    fused FeCL's kernels), library (cuDNN and cuBLAS convs and matmuls) or
    other (elementwise, reductions, copies). K1-dW is tested first: its name
    contains K1's."""
    n = name.lower()
    if "fecl_" in n:
        return "k2"
    if "folded_conv3_dw" in n or "sum_splits" in n:
        return "k1_dw"
    if "folded_conv3" in n:
        return "k1"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit", "cutlass", "gemm", "sm90")):
        return "library"
    return "other"


def device_ms_by_category(prof, reps: int):
    """({category: device ms per rep}, [(ms per rep, launches per rep, name)])
    over the kernel events of a finished profile of `reps` repetitions."""
    by_cat = {"k1": 0.0, "k1_dw": 0.0, "k2": 0.0, "library": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        # kernel events only: operator events carry their kernels' time as children
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if "CUDA" not in str(ev.device_type) or dev_us <= 0:
            continue
        by_cat[category(ev.key)] += dev_us / 1e3 / reps
        kernels.append((dev_us / 1e3 / reps, ev.count // reps, ev.key[:90]))
    return by_cat, sorted(kernels, reverse=True)
