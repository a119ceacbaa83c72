"""Step timing and tracing hooks.

Counterpart of dycon_paper_replication_tpu/utils/profiling.py:
  * `StepTimer`: a rolling window of wall-clock step times with p50/p95 and
    steps per second; `start()` returns its mark, so a caller can carry its
    own start into `stop(start=...)`. The caller syncs: the trainer stops
    the timer after the step's scalars reach the host, so the JAX timer's
    sampled `stop(result)` sync has no counterpart;
  * `trace(logdir)`: torch.profiler around a block (CPU and, where there is
    a card, CUDA activity), written as a Chrome trace file into `logdir`
    (scripts/profile_torch_train.py).
Not ported: `debug_nans`, which nothing calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import numpy as np
import torch


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = deque(maxlen=window)
        self._last = None

    def start(self) -> float:
        """Mark (and return) a step's start."""
        self._last = time.perf_counter()
        return self._last

    def stop(self, start: float | None = None) -> float:
        """Record the step since `start` (default: the last `start()`)."""
        dt = time.perf_counter() - (self._last if start is None else start)
        self.window.append(dt)
        return dt

    def stats(self) -> dict:
        if not self.window:
            return {}
        arr = np.asarray(self.window)
        return {
            "steps_per_sec": float(1.0 / arr.mean()),
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p95": float(np.percentile(arr, 95) * 1e3),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, yielding the profiler; writes <logdir>/trace.json
    (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
