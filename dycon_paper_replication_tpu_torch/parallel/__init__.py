"""Data parallelism: the rank count, the per-rank batch, collectives and the
launcher (mesh.py)."""

from .mesh import (
    Shard,
    active,
    distributed_init,
    eval_devices,
    from_env,
    launch,
    make_mesh,
    replicate,
    shard_batch,
    sharded,
)

__all__ = ["Shard", "active", "distributed_init", "eval_devices", "from_env", "launch",
           "make_mesh", "replicate", "shard_batch", "sharded"]
