"""Model factory: name -> UNet3D or VNet module.

Counterpart of dycon_paper_replication_tpu/models/factory.py. `unet_3D`
is the UNet3D, with ASPP on its bottleneck when `use_aspp`; `vnet` is the
VNet with the DyCON three-head interface. As in the JAX factory,
`use_aspp` reaches the UNet3D only: the VNet takes no ASPP, and the flag
leaves it unchanged. The UNet3D carries the folded sliding-window entry
(`UNet3D.apply_seg_folded`); the VNet has none, so the sliding window runs
its patches through `forward`, which folds inside.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import resolve_device
from .unet3d import UNet3D, UNet3DConfig
from .vnet import VNet, VNetConfig


def build_model(cfg: UNet3DConfig | VNetConfig) -> nn.Module:
    """The module of a config, on the CPU, uninitialised."""
    return VNet(cfg) if isinstance(cfg, VNetConfig) else UNet3D(cfg)


def model_config(net_type: str = "unet_3D", in_chns: int = 1, class_num: int = 2,
                 scaler: int = 4, use_aspp: bool = False,
                 layout: str = "NDHWC") -> UNet3DConfig | VNetConfig:
    if net_type == "unet_3D":
        return UNet3DConfig(in_channels=in_chns, n_classes=class_num, scale_factor=int(scaler),
                            use_aspp=bool(use_aspp), layout=layout)
    if net_type == "vnet":
        return VNetConfig(in_channels=in_chns, n_classes=class_num, scale_factor=int(scaler),
                          layout=layout)
    raise ValueError(f"unknown net_type: {net_type!r}")


def net_factory_3d(net_type: str = "unet_3D", in_chns: int = 1, class_num: int = 2,
                   scaler: int = 4, use_aspp: bool = False, layout: str = "NDHWC",
                   device: torch.device | str = "cuda") -> nn.Module:
    """An eval-mode UNet3D or VNet on `device` (which must exist: cuda
    raises when missing) with uninitialised weights: load a checkpoint
    (utils/checkpoint) or a state_dict (weights.py) before use."""
    cfg = model_config(net_type, in_chns, class_num, scaler, use_aspp, layout)
    return build_model(cfg).to(resolve_device(device)).eval()
