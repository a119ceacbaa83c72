"""3-D Atrous Spatial Pyramid Pooling, the optional refiner of the UNet3D's
bottleneck before its projection head (`--use_aspp 1`).

Counterpart of dycon_paper_replication_tpu/models/aspp.py. Five parallel
branches over the bottleneck: a 1^3 conv, three 3^3 convs at dilations
6 / 12 / 18 (output_stride 16; 12 / 24 / 36 at 8), each with BatchNorm and
ReLU, and a global-average-pool branch (1^3 conv, BatchNorm, ReLU, a
corner-aligned resize back to the bottleneck's size); their concatenation
is fused by a 1^3 conv, BatchNorm, ReLU and dropout(0.5). Every conv is
bias-free. The dilated convs are library convs (cuDNN on the card), as the
JAX layer's are lax.conv outside any Pallas kernel.

Kept from the reference: the pooled branch skips its BatchNorm when the
batch has one sample (its statistics would be of one value), decided by
the batch size as the JAX layer decides it statically.

`compute_dtype` is the model's: every conv casts its input and weight to
it, so in bfloat16 the branches and their concatenation are bfloat16. The
JAX layer passes no compute dtype to its convs, so under its bfloat16 model
(a bfloat16 bottleneck against float32 weights) lax.conv refuses the mixed
operands; the port casts them as the JAX package's other convs do.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import mesh
from . import layers
from ..ops.resize import global_avg_pool, trilinear_resize


def dilations(output_stride: int) -> tuple[int, ...]:
    if output_stride == 16:
        return (1, 6, 12, 18)
    if output_stride == 8:
        return (1, 12, 24, 36)
    raise NotImplementedError(f"output_stride {output_stride}")


class ASPPBranch(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int, int],
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = layers.Conv3d(in_ch, out_ch, kernel, use_bias=False,
                                  compute_dtype=compute_dtype)
        self.bn = layers.BatchNorm(out_ch)


class ASPP3D(nn.Module):
    """Parameters and state under the JAX tree's names: aspp1..aspp4 (conv,
    bn), pool_conv, pool_bn, fuse_conv, fuse_bn. The JAX tree keeps a
    branch's running stats at aspp<i> itself, the port's module at
    aspp<i>.bn; weights.py maps one onto the other."""

    def __init__(self, inplanes: int, outplanes: int, output_stride: int = 16,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.dilations = dilations(output_stride)
        for i, _ in enumerate(self.dilations):
            kernel = (1, 1, 1) if i == 0 else (3, 3, 3)
            setattr(self, f"aspp{i + 1}", ASPPBranch(inplanes, outplanes, kernel, compute_dtype))
        self.pool_conv = layers.Conv3d(inplanes, outplanes, (1, 1, 1), use_bias=False,
                                       compute_dtype=compute_dtype)
        self.pool_bn = layers.BatchNorm(outplanes)
        self.fuse_conv = layers.Conv3d(outplanes * 5, outplanes, (1, 1, 1), use_bias=False,
                                       compute_dtype=compute_dtype)
        self.fuse_bn = layers.BatchNorm(outplanes)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        """x (B, D1, D2, D3, inplanes) -> (B, D1, D2, D3, outplanes). The
        BatchNorms follow the module's mode; the dropout applies only in
        training mode with a threefry key."""
        branches = []
        for i, dil in enumerate(self.dilations):
            branch = getattr(self, f"aspp{i + 1}")
            h = layers.conv3d(x, branch.conv.w, padding="SAME" if i else "VALID", dilation=dil,
                              compute_dtype=branch.conv.compute_dtype)
            branches.append(layers.relu(branch.bn(h)))
        pooled = self.pool_conv(global_avg_pool(x))
        shard = mesh.active()  # a data-parallel step: the global batch decides
        if (x.shape[0] if shard is None else shard.global_batch) > 1:
            pooled = self.pool_bn(pooled)
        pooled = trilinear_resize(layers.relu(pooled), tuple(branches[-1].shape[1:4]),
                                  align_corners=True)
        branches.append(pooled)
        h = self.fuse_conv(torch.cat(branches, dim=-1))
        h = layers.relu(self.fuse_bn(h))
        return layers.dropout(h, 0.5, key, self.training)
