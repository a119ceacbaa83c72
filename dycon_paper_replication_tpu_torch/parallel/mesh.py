"""Data parallelism over torch.distributed: one process per device.

Counterpart of dycon_paper_replication_tpu/parallel/mesh.py. The JAX
package runs one SPMD program over a 1-D device mesh: the batch sharded
over the mesh, parameters, optimizer and teacher replicated, and GSPMD
making every reduction global, so its mesh step IS the single-device step
on the global batch (tests/test_train.py's DP exactness tests). The port
keeps that contract with explicit collectives:

  * `make_mesh`: the rank count of `--data_parallel N`: N as
    given (clamped to the visible cards on CUDA, as make_mesh clamps to the
    devices), or with 0 every visible device (1 on the CPU) clamped to
    divide the batch (make_mesh's `batch_size` clamp) and its labeled part;
  * `Shard` / `shard_batch`: rank r takes labeled_bs / N labeled rows and
    (batch_size - labeled_bs) / N unlabeled ones of the global batch, so its
    local batch keeps the two-stream layout (labeled rows first) and the
    step's `[:labeled_bs]` slices stay local; every rank reads the global
    batch from the same seed and keeps its rows;
  * `replicate` broadcasts a module's parameters and buffers from rank 0;
  * `Shard.all_sum`: a differentiable all-reduce (sum): its backward
    all-reduces the cotangent, the adjoint of a sum that every rank uses
    when the global loss is the sum of the ranks' terms. The train step
    (train/step.py) writes the global loss as such a sum: a mean over the
    global batch is each rank's local sum over the global count; the Dice
    ratio, the BatchNorm statistics and FeCL's cross-pair count take their
    sums through all_sum. Gradients are then all-reduced by sum;
  * `sharded(shard)` makes a Shard visible to the layers that need the
    global batch (models/layers.py: train-mode BatchNorm statistics and
    dropout masks; ops/folding.py:batch_norm_folded; models/aspp.py): the
    statistics are cross-rank sums, the masks are drawn for the global batch
    and sliced per rank, as the teacher noise is in the step;
  * `distributed_init` / `launch`: `train_* --data_parallel N` spawns N
    workers (torch.multiprocessing, a file store under the temporary
    directory), NCCL on CUDA and gloo on the CPU; a process started by
    torchrun (WORLD_SIZE set) joins as one rank (`from_env`);
  * `eval_devices`: the devices of the test CLIs' `--data_parallel N`
    (evaluation in one process over N devices, as in JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=60)  # rank 0 validates while the others wait


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's part of the global batch."""

    rank: int
    world: int
    global_batch: int
    global_labeled: int

    @property
    def labeled(self) -> int:
        return self.global_labeled // self.world

    @property
    def unlabeled(self) -> int:
        return (self.global_batch - self.global_labeled) // self.world

    @property
    def batch(self) -> int:
        return self.labeled + self.unlabeled

    @property
    def rows(self) -> np.ndarray:
        """This rank's rows of the global batch: its labeled rows, then its
        unlabeled ones."""
        lab = np.arange(self.rank * self.labeled, (self.rank + 1) * self.labeled)
        unl = self.global_labeled + np.arange(self.rank * self.unlabeled,
                                              (self.rank + 1) * self.unlabeled)
        return np.concatenate([lab, unl])

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks, differentiable (module doc)."""
        return _AllSum.apply(x)

    def all_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place all-reduce (sum) of a tensor no gradient flows through."""
        dist.all_reduce(x)
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-rank (local batch, ...) tensor, rows in
        the global batch's order, on every rank."""
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
        out = torch.empty((self.global_batch,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for r, part in enumerate(parts):
            rows = dataclasses.replace(self, rank=r).rows
            out[torch.as_tensor(rows, device=x.device)] = part
        return out

    def rows_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (global batch, ...) tensor."""
        return x[torch.as_tensor(self.rows, device=x.device)]


class _AllSum(torch.autograd.Function):
    """y = sum over ranks of x on every rank; dx = sum over ranks of dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx)
        return dx


_active: Shard | None = None


def active() -> Shard | None:
    """The Shard of the data-parallel step being run, or None."""
    return _active


@contextlib.contextmanager
def sharded(shard: Shard | None):
    """Make `shard` visible to the layers inside the block (module doc)."""
    global _active
    previous, _active = _active, shard
    try:
        yield shard
    finally:
        _active = previous


def visible_devices(device: str | torch.device) -> int:
    """The device count of `device`'s type: the visible cards on CUDA, 1 on
    the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def make_mesh(n_devices: int = 0, device: str | torch.device = "cpu",
              batch_size: int | None = None, labeled_bs: int | None = None) -> int:
    """The rank count over the first `n_devices` devices (0 = every visible
    one), clamped to the visible cards on CUDA (the CPU runs any number of
    processes); with `batch_size`, clamped to the largest count that divides
    it and `labeled_bs` (each rank takes an equal share of both)."""
    n = n_devices if n_devices > 0 else visible_devices(device)
    if torch.device(device).type == "cuda":
        n = min(n, max(visible_devices(device), 1))
    if batch_size is not None:
        while n > 1 and (batch_size % n or (labeled_bs or 0) % n):
            n -= 1
    return max(n, 1)


def shard_batch(shard: Shard | None, batch: dict) -> dict:
    """This rank's rows of a global host batch ({name: (B, ...) array})."""
    if shard is None:
        return batch
    rows = shard.rows
    return {k: v[rows] for k, v in batch.items()}


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def distributed_init(rank: int, world: int, init_method: str, backend: str | None = None,
                     device: str | torch.device = "cpu") -> None:
    """Join the process group: NCCL on CUDA, gloo on the CPU unless
    `backend` says otherwise (gloo also all-reduces CUDA tensors)."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT)


def from_env() -> tuple[int, int, int] | None:
    """(rank, world, local rank) of a process started by torchrun, or None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def _worker(rank: int, fn: Callable, world: int, devices: Sequence[str], init_method: str,
            backend: str | None, threads: int | None, result_path: str, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    distributed_init(rank, world, init_method, backend, device)
    try:
        out = fn(rank, world, device, *args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *, device: str = "cpu", devices: Sequence[str] | None = None,
           backend: str | None = None, args: tuple = (), threads: int | None = None,
           timeout: float | None = None):
    """Run fn(rank, world, device, *args) in `world` spawned processes that
    have joined one process group (a file store under the temporary
    directory); returns rank 0's result. `devices` defaults to one per rank
    (cuda:0.. on CUDA, the CPU otherwise); `backend` to NCCL on CUDA and
    gloo on the CPU. With `timeout` (seconds), ranks still running then are
    killed and TimeoutError is raised."""
    import torch.multiprocessing as mp

    if devices is None:
        devices = ([f"cuda:{r}" for r in range(world)] if torch.device(device).type == "cuda"
                   else ["cpu"] * world)
    with tempfile.TemporaryDirectory(prefix="dycon_dist_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        result_path = os.path.join(tmp, "result.pt")
        procs = mp.start_processes(
            _worker, args=(fn, world, [str(d) for d in devices], init_method, backend, threads,
                           result_path, args), nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not procs.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in procs.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"data-parallel ranks still running after {timeout} s")
        return torch.load(result_path, weights_only=False)


def eval_devices(device: str | torch.device, n: int) -> list[torch.device] | None:
    """The devices of the test CLIs' `--data_parallel n`: None (the model's
    own device) for 0 and 1, else the first n cards on CUDA, clamped to the
    visible ones, or n replicas on the CPU."""
    if n <= 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device(f"cuda:{i}") for i in range(min(n, max(visible_devices(device), 1)))]
    return [device] * n
