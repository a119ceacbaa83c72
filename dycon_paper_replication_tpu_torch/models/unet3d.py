"""3-D U-Net with three heads, as an nn.Module.

Counterpart of dycon_paper_replication_tpu/models/unet3d.py:
  encoder: 4 x [UnetConv3 -> 2x2x2 max pool], center UnetConv3 + dropout(0.3);
           UnetConv3 = 2 x (3^3 conv -> InstanceNorm -> ReLU)
  decoder: 4 x [trilinear 2x up -> concat skip -> UnetConv3], dropout(0.3)
  heads:   `final` 1^3 conv + tanh   -> SDF map
           `out_conv2` 1^3 conv      -> segmentation logits
           projection: corner-aligned trilinear up(x scale_factor) of the
           bottleneck (refined by ASPP with `use_aspp`, models/aspp.py)
           -> 1^3 conv(512) -> BN -> ReLU -> 1^3 conv(256) -> BN
  filters: [64, 128, 256, 512, 1024] // feature_scale (4 -> 16..256)

Inputs and outputs are channels-last float32. `cfg.layout` is "NDHWC" (the
plain path here) or "folded" (models/unet3d_folded.py: levels 1-2 in fold-2
execution through the K1 kernel on the card). The submodule names are the
JAX parameter tree's, so weights.py maps one onto the other by name.

`cfg.compute_dtype` (float32 or bfloat16) is the JAX config's: every conv
casts its input and weight to it, the norms keep it, a skip is cast to the
upsampled tensor's dtype before the concatenation, and the three heads are
cast to float32, so the losses see float32. Parameters and BatchNorm
running statistics stay float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import layers
from .aspp import ASPP3D
from ..ops import threefry
from ..ops.resize import max_pool_2x, trilinear_resize, upsample2x


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 1
    n_classes: int = 2
    feature_scale: int = 4
    scale_factor: int = 2  # projection-head upsample factor
    use_aspp: bool = False
    dropout_rate: float = 0.3
    proj_hidden: int = 512
    proj_out: int = 256
    compute_dtype: torch.dtype = torch.float32
    layout: str = "NDHWC"  # "NDHWC" or "folded"

    @property
    def filters(self) -> tuple[int, ...]:
        return tuple(f // self.feature_scale for f in (64, 128, 256, 512, 1024))


class UnetConv3(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = layers.Conv3d(in_ch, out_ch, compute_dtype=compute_dtype)
        self.conv2 = layers.Conv3d(out_ch, out_ch, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.relu(layers.instance_norm(self.conv1(x)))
        return layers.relu(layers.instance_norm(self.conv2(x)))


class ProjectionHead(nn.Module):
    def __init__(self, in_ch: int, hidden: int, out: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = layers.Conv3d(in_ch, hidden, (1, 1, 1), compute_dtype=compute_dtype)
        self.bn1 = layers.BatchNorm(hidden)
        self.conv2 = layers.Conv3d(hidden, out, (1, 1, 1), compute_dtype=compute_dtype)
        self.bn2 = layers.BatchNorm(out)


_ENCODER = ("conv1", "conv2", "conv3", "conv4")
_DECODER = ("up_concat4", "up_concat3", "up_concat2", "up_concat1")


class UNet3D(nn.Module):
    def __init__(self, cfg: UNet3DConfig):
        super().__init__()
        if cfg.layout not in ("NDHWC", "folded"):
            raise ValueError(f"unknown layout {cfg.layout!r}")
        self.cfg = cfg
        f = cfg.filters
        cd = cfg.compute_dtype
        self.conv1 = UnetConv3(cfg.in_channels, f[0], cd)
        self.conv2 = UnetConv3(f[0], f[1], cd)
        self.conv3 = UnetConv3(f[1], f[2], cd)
        self.conv4 = UnetConv3(f[2], f[3], cd)
        self.center = UnetConv3(f[3], f[4], cd)
        self.up_concat4 = UnetConv3(f[4] + f[3], f[3], cd)
        self.up_concat3 = UnetConv3(f[3] + f[2], f[2], cd)
        self.up_concat2 = UnetConv3(f[2] + f[1], f[1], cd)
        self.up_concat1 = UnetConv3(f[1] + f[0], f[0], cd)
        self.final = layers.Conv3d(f[0], cfg.n_classes, (1, 1, 1), compute_dtype=cd)
        self.out_conv2 = layers.Conv3d(f[0], cfg.n_classes, (1, 1, 1), compute_dtype=cd)
        self.projection = ProjectionHead(f[4], cfg.proj_hidden, cfg.proj_out, cd)
        if cfg.use_aspp:
            self.aspp = ASPP3D(f[4], f[4], compute_dtype=cd)

    def forward(self, x: torch.Tensor, *, with_projection: bool = True, key=None):
        """x: (B, D1, D2, D3, in_channels), spatial dims divisible by 16.
        Returns (sdf, seg_logits, features), float32 channels-last;
        features is None with `with_projection=False`. Dropout applies only
        in training mode with a threefry key (ops/threefry.py), split as the
        JAX model splits its rng (unet3d.py:197): the centre's key, the last
        decoder map's, ASPP's."""
        if self.cfg.layout == "folded":
            from .unet3d_folded import unet3d_apply_folded

            return unet3d_apply_folded(self, x, with_projection=with_projection, key=key)
        train = self.training
        d1_key, d2_key, aspp_key = dropout_keys(key, train)
        skips = []
        h = x
        for name in _ENCODER:
            h = getattr(self, name)(h)
            skips.append(h)
            h = max_pool_2x(h)
        center = layers.dropout(self.center(h), self.cfg.dropout_rate, d1_key, train)
        h = center
        for name, skip in zip(_DECODER, skips[::-1]):
            up = upsample2x(h)
            h = getattr(self, name)(torch.cat([skip.to(up.dtype), up], dim=-1))
        h = layers.dropout(h, self.cfg.dropout_rate, d2_key, train)
        sdf = torch.tanh(self.final(h).to(torch.float32))
        seg = self.out_conv2(h).to(torch.float32)
        features = projection_head(self, center, key=aspp_key) if with_projection else None
        return sdf, seg, features

    def apply_seg_folded(self, xf: torch.Tensor) -> torch.Tensor:
        """Eval-mode seg logits with folded input and output, the sliding
        window's folded entry (see unet3d_folded.unet3d_seg_folded_io)."""
        from .unet3d_folded import unet3d_seg_folded_io

        return unet3d_seg_folded_io(self, xf)


def dropout_keys(key, train: bool, n: int = 3) -> tuple:
    """The JAX model's split of its rng into its dropout keys (centre,
    decoder, and ASPP for the UNet3D), or Nones outside training."""
    if not train or key is None:
        return (None,) * n
    return tuple(threefry.split(key, n))


def projection_head(net, center: torch.Tensor, key=None) -> torch.Tensor:
    """ASPP (where `net` has one) + corner-aligned upsample +
    conv-BN-ReLU-conv-BN of the bottleneck; the UNet3D's and the VNet's. In
    training mode the BatchNorms use the batch statistics and update their
    running stats (the JAX head's new BN state), and ASPP's dropout draws
    from `key`."""
    aspp = getattr(net, "aspp", None)
    if aspp is not None:
        center = aspp(center, key=key)
    p = net.projection
    target = tuple(s * net.cfg.scale_factor for s in center.shape[1:4])
    proj = trilinear_resize(center, target, align_corners=True)
    proj = layers.relu(p.bn1(p.conv1(proj)))
    return p.bn2(p.conv2(proj)).to(torch.float32)
