"""V-Net with the DyCON three-head interface, as an nn.Module.

Counterpart of dycon_paper_replication_tpu/models/vnet.py:
  encoder: 5 levels of ConvBlock (n x [3^3 conv -> BatchNorm -> ReLU], n =
           1, 2, 3, 3, 3), each of the first four followed by a strided 2^3
           conv -> BatchNorm -> ReLU (`down0..3`); dropout(0.5) at the centre
  decoder: 4 levels of transposed 2^3 conv -> BatchNorm -> ReLU (`up0..3`),
           an ADDITIVE skip, and a ConvBlock (n = 3, 3, 2, 1); dropout(0.5)
  heads:   `out_conv` 1^3 conv -> segmentation logits,
           `out_conv_sdf` 1^3 conv + tanh -> SDF map,
           `projection` the UNet3D's projection head over the centre
  filters: n_filters x (1, 2, 4, 8, 16), 16..256 at the default 16.

The JAX package fixes the reference's vnet, which its factory could not
build and which returned one output, with this `(sdf, seg, features)`
interface; the port keeps it. Every BatchNorm takes batch statistics in
training mode. Inputs and outputs are channels-last float32. `cfg.layout`
is "NDHWC" (the plain path here) or "folded" (models/vnet_folded.py: the
two full- and half-resolution levels in fold-2 execution, through K1 on the
card). The submodule names are the JAX parameter tree's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import layers
from .unet3d import ProjectionHead, projection_head

# conv stages per encoder / decoder block
ENC_STAGES = (1, 2, 3, 3, 3)
DEC_STAGES = (3, 3, 2, 1)


@dataclasses.dataclass(frozen=True)
class VNetConfig:
    in_channels: int = 1
    n_classes: int = 2
    n_filters: int = 16
    scale_factor: int = 2  # projection-head upsample factor
    dropout_rate: float = 0.5
    proj_hidden: int = 512
    proj_out: int = 256
    layout: str = "NDHWC"  # "NDHWC" or "folded"

    @property
    def filters(self) -> tuple[int, ...]:
        return tuple(self.n_filters * m for m in (1, 2, 4, 8, 16))


class ConvBlock(nn.Module):
    """n_stages x [3^3 conv -> BatchNorm -> ReLU]: conv0, bn0, conv1, ..."""

    def __init__(self, n_stages: int, in_ch: int, out_ch: int):
        super().__init__()
        self.n_stages = n_stages
        for i in range(n_stages):
            setattr(self, f"conv{i}", layers.Conv3d(in_ch if i == 0 else out_ch, out_ch))
            setattr(self, f"bn{i}", layers.BatchNorm(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_stages):
            x = layers.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class Resample(nn.Module):
    """A 2^3 stride-2 conv (down) or transposed conv (up), BatchNorm, ReLU."""

    def __init__(self, in_ch: int, out_ch: int, up: bool):
        super().__init__()
        self.up = up
        self.conv = (layers.ConvTranspose3d if up else layers.Conv3d)(in_ch, out_ch, (2, 2, 2))
        self.bn = layers.BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            h = self.conv(x)
        else:
            h = layers.conv3d(x, self.conv.w, self.conv.b, stride=2, padding="VALID")
        return layers.relu(self.bn(h))


class VNet(nn.Module):
    def __init__(self, cfg: VNetConfig):
        super().__init__()
        if cfg.layout not in ("NDHWC", "folded"):
            raise ValueError(f"unknown layout {cfg.layout!r}")
        self.cfg = cfg
        f = cfg.filters
        ch = cfg.in_channels
        for lvl, stages in enumerate(ENC_STAGES):
            setattr(self, f"enc{lvl}", ConvBlock(stages, ch, f[lvl]))
            if lvl < 4:
                setattr(self, f"down{lvl}", Resample(f[lvl], f[lvl + 1], up=False))
            ch = f[lvl + 1] if lvl < 4 else f[lvl]
        for lvl in range(4):  # up from level 4 to level 1
            setattr(self, f"up{lvl}", Resample(f[4 - lvl], f[3 - lvl], up=True))
            setattr(self, f"dec{lvl}", ConvBlock(DEC_STAGES[lvl], f[3 - lvl], f[3 - lvl]))
        self.out_conv = layers.Conv3d(f[0], cfg.n_classes, (1, 1, 1))
        self.out_conv_sdf = layers.Conv3d(f[0], cfg.n_classes, (1, 1, 1))
        self.projection = ProjectionHead(f[4], cfg.proj_hidden, cfg.proj_out)

    def forward(self, x: torch.Tensor, *, with_projection: bool = True,
                generator: torch.Generator | None = None):
        """x: (B, D1, D2, D3, in_channels), spatial dims divisible by 16.
        Returns (sdf, seg_logits, features), float32 channels-last;
        features is None with `with_projection=False`. Dropout applies only
        in training mode with a generator: the centre's draw, then the
        last decoder map's."""
        if self.cfg.layout == "folded":
            from .vnet_folded import vnet_apply_folded

            return vnet_apply_folded(self, x, with_projection=with_projection,
                                     generator=generator)
        train, rate = self.training, self.cfg.dropout_rate
        skips = []
        h = x
        for lvl in range(5):
            h = getattr(self, f"enc{lvl}")(h)
            if lvl < 4:
                skips.append(h)
                h = getattr(self, f"down{lvl}")(h)
        center = layers.dropout(h, rate, generator, train)
        h = center
        for lvl in range(4):
            h = getattr(self, f"up{lvl}")(h) + skips[3 - lvl]
            h = getattr(self, f"dec{lvl}")(h)
        h = layers.dropout(h, rate, generator, train)
        seg = self.out_conv(h).to(torch.float32)
        sdf = torch.tanh(self.out_conv_sdf(h).to(torch.float32))
        features = projection_head(self, center) if with_projection else None
        return sdf, seg, features
