"""Layers over channels-last (B, D1, D2, D3, C) volumes.

Counterpart of dycon_paper_replication_tpu/models/layers.py. Conv kernels
are kept in the JAX package's DHWIO layout (kd, kh, kw, Ci, Co), so the
fold-2 engine folds them directly and a JAX parameter tree maps onto the
port's state_dict without reordering.

`compute_dtype` is the JAX layers': a conv casts its input and its weight
to it (None: the weight to the input's dtype) and emits it, and the bias is
cast to the output's dtype before it is added, after the conv's own
rounding. The norms take float32 statistics and return the input's dtype;
parameters and running statistics stay float32. A train-mode BatchNorm
writes its running statistics through `update_running_stats`, which does
nothing inside `frozen_running_stats()`: the recompute of a checkpointed
forward (train/step.py, remat "full") must not move them a second time.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import threefry
from ..ops.folded_conv_cuda import cast_operands, library_conv
from ..parallel import mesh


class Conv3d(nn.Module):
    """Parameters of one 3-D conv: `w` (kd, kh, kw, Ci, Co) and bias `b` (Co,),
    or no bias with `use_bias=False` (ASPP's convs, in front of a BatchNorm).
    The forward computes in `compute_dtype` (see conv3d)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int, int] = (3, 3, 3),
                 use_bias: bool = True, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(*kernel, in_ch, out_ch))
        self.b = nn.Parameter(torch.empty(out_ch)) if use_bias else None
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.w, self.b, compute_dtype=self.compute_dtype)


class ConvTranspose3d(nn.Module):
    """Parameters of one transposed 3-D conv, in the JAX package's layout:
    `w` (kd, kh, kw, Ci, Co) and bias `b` (Co,). See conv_transpose3d."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int, int] = (2, 2, 2),
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(*kernel, in_ch, out_ch))
        self.b = nn.Parameter(torch.empty(out_ch))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose3d(x, self.w, self.b, compute_dtype=self.compute_dtype)


class BatchNorm(nn.Module):
    """BatchNorm parameters (`scale`, `bias`) and running stats (`mean`, `var`).

    In training mode it normalises with the batch statistics and updates the
    running stats in place (the JAX layer returns them as a new state)."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm(x, self.scale, self.bias, self.mean, self.var)
        y, mean, var = batch_norm_train(x, self.scale, self.bias, self.mean, self.var)
        update_running_stats(self, mean, var)
        return y


_stats_frozen = False  # inside frozen_running_stats()


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode BatchNorms leave their running stats as they are inside
    the block. A process-wide switch, not a thread-local one: the autograd
    engine recomputes a checkpointed forward on its own thread on CUDA."""
    global _stats_frozen
    prev, _stats_frozen = _stats_frozen, True
    try:
        yield
    finally:
        _stats_frozen = prev


@torch.no_grad()
def update_running_stats(bn: BatchNorm, mean: torch.Tensor, var: torch.Tensor) -> None:
    """bn's running stats <- (mean, var), unless frozen_running_stats()."""
    if not _stats_frozen:
        bn.mean.copy_(mean)
        bn.var.copy_(var)


def _add_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: str = "SAME", dilation: int = 1,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """3-D conv of (B, D1, D2, D3, Ci) with a DHWIO kernel: "SAME" (stride 1,
    odd kernel sizes, zero pad dilation * (k - 1) / 2) or "VALID" padding,
    the same stride and dilation on every axis. F.conv3d reads the
    channels-last tensor through an NCDHW view, which cuDNN takes as
    channels_last_3d."""
    if padding == "SAME":
        if stride != 1:
            raise ValueError("conv3d: SAME padding takes stride 1 only")
        pad = tuple(dilation * (k // 2) for k in w.shape[:3])
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"conv3d: padding must be SAME or VALID, got {padding!r}")
    x, w = cast_operands(x, w, compute_dtype)
    y = library_conv(F.conv3d, x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                     stride=stride, padding=pad, dilation=dilation)
    return _add_bias(y.permute(0, 2, 3, 4, 1), b)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Transposed 3-D conv of (B, D1, D2, D3, Ci), stride 2, VALID, with the
    JAX layer's kernel w (kd, kh, kw, Ci, Co): a kernel of 2 doubles every
    spatial axis. The JAX layer is lax.conv_transpose with
    transpose_kernel=False, which mirrors the kernel spatially against
    F.conv_transpose3d: y[2i + p] = x[i] w[1 - p] where torch computes
    x[i] w[p]. The flip is here, once; the weights keep the JAX layout."""
    x, w = cast_operands(x, w, compute_dtype)
    wt = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)  # (Ci, Co, kd, kh, kw)
    y = library_conv(F.conv_transpose3d, x.permute(0, 4, 1, 2, 3), wt, stride=2)
    return _add_bias(y.permute(0, 2, 3, 4, 1), b)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over the spatial axes: no affine
    part, no running stats, float32 statistics, two-pass variance."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode channel BatchNorm over the last axis, from running stats."""
    y = (x.to(torch.float32) - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor, momentum: float = 0.1,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode channel BatchNorm over the last axis: normalise with the
    batch mean and the biased batch variance (two-pass); the running stats
    move by `momentum` towards the batch mean and the UNBIASED variance
    (n / (n - 1)), the torch convention. Returns (y, new_mean, new_var),
    the new stats detached. Inside a data-parallel step (parallel.sharded)
    the statistics are those of the global batch: both passes' sums go
    through the differentiable cross-rank sum, over the global count."""
    xf = x.to(torch.float32)
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    shard = mesh.active()
    if shard is None:
        b_mean = xf.mean(dim=dims)
        b_var = (xf - b_mean).square().mean(dim=dims)
    else:
        n *= shard.world
        b_mean = shard.all_sum(xf.sum(dim=dims)) / n
        b_var = shard.all_sum((xf - b_mean).square().sum(dim=dims)) / n
    unbiased = b_var.detach() * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * mean + momentum * b_mean.detach()
    new_var = (1 - momentum) * var + momentum * unbiased
    y = (xf - b_mean) * torch.rsqrt(b_var + eps)
    return (y * scale + bias).to(x.dtype), new_mean, new_var


def relu(x: torch.Tensor) -> torch.Tensor:
    """torch.relu. Every ReLU of the models calls it here, so that the
    card-against-CPU step check (train/device_check.py) can replace it."""
    return torch.relu(x)


def dropout(x: torch.Tensor, rate: float, key, train: bool) -> torch.Tensor:
    """Inverted dropout, where(bernoulli(key, keep, x.shape), x / keep, 0):
    the JAX layer's masks from the same threefry key (ops/threefry.py: the
    kernel on the card, its backward redrawing the mask); the identity
    unless training with a key, as the JAX layer is without one. Inside a
    data-parallel step a rank draws its own rows of the global batch's
    mask."""
    if not train or rate == 0.0 or key is None:
        return x
    shard = mesh.active()
    return threefry.dropout(x, key, 1.0 - rate, None if shard is None else shard.rows)
