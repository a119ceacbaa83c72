"""Layers over channels-last (B, D1, D2, D3, C) volumes.

Counterpart of dycon_paper_replication_tpu/models/layers.py. Conv kernels
are kept in the JAX package's DHWIO layout (kd, kh, kw, Ci, Co), so the
fold-2 engine folds them directly and a JAX parameter tree maps onto the
port's state_dict without reordering.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv3d(nn.Module):
    """Parameters of one 3-D conv: `w` (kd, kh, kw, Ci, Co) and bias `b` (Co,)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        self.w = nn.Parameter(torch.empty(*kernel, in_ch, out_ch))
        self.b = nn.Parameter(torch.empty(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.w, self.b)


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


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """SAME-padded stride-1 3-D conv of (B, D1, D2, D3, Ci) with a DHWIO
    kernel (odd sizes). F.conv3d reads the channels-last tensor through an
    NCDHW view, which cuDNN takes as channels_last_3d."""
    pad = tuple(k // 2 for k in w.shape[:3])
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, padding=pad)
    return y.permute(0, 2, 3, 4, 1)


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
    """torch.relu. Every ReLU of the UNet3D calls it here, so that the
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
