"""Layers over channels-last (B, D1, D2, D3, C) volumes.

Counterpart of dycon_paper_replication_tpu/models/layers.py. Conv kernels
are kept in the JAX package's DHWIO layout (kd, kh, kw, Ci, Co), so the
fold-2 engine folds them directly and a JAX parameter tree maps onto the
port's state_dict without reordering.

`compute_dtype` is the JAX layers': a conv casts its input and its weight
to it (None: the weight to the input's dtype) and emits it, and the bias is
cast to the output's dtype before it is added, after the conv's own
rounding. The norms take float32 statistics and return the input's dtype;
parameters and running statistics stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.folded_conv_cuda import cast_operands, library_conv


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
        with torch.no_grad():
            self.mean.copy_(mean)
            self.var.copy_(var)
        return y


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
    the new stats detached."""
    xf = x.to(torch.float32)
    dims = tuple(range(x.dim() - 1))
    b_mean = xf.mean(dim=dims)
    b_var = (xf - b_mean).square().mean(dim=dims)
    n = x.numel() // x.shape[-1]
    unbiased = b_var.detach() * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * mean + momentum * b_mean.detach()
    new_var = (1 - momentum) * var + momentum * unbiased
    y = (xf - b_mean) * torch.rsqrt(b_var + eps)
    return (y * scale + bias).to(x.dtype), new_mean, new_var


def relu(x: torch.Tensor) -> torch.Tensor:
    """torch.relu. Every ReLU of the models calls it here, so that the
    card-against-CPU step check (train/device_check.py) can replace it."""
    return torch.relu(x)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """Inverted dropout (scale by 1/keep); the identity unless training with
    a generator, as the JAX layer is without a key."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
