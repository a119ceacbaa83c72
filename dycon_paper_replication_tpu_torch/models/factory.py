"""Model factory: name -> UNet3D module.

Counterpart of dycon_paper_replication_tpu/models/factory.py for
`unet_3D`. The module itself carries the folded sliding-window entry
(`UNet3D.apply_seg_folded`); the JAX factory attaches it to its Model only
for layout "folded", and the port's engine reads `cfg.layout` for the same
choice. VNet is not ported yet.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from .unet3d import UNet3D, UNet3DConfig


def net_factory_3d(net_type: str = "unet_3D", in_chns: int = 1, class_num: int = 2,
                   scaler: int = 4, layout: str = "NDHWC",
                   device: torch.device | str = "cuda") -> UNet3D:
    """An eval-mode UNet3D on `device` (which must exist: cuda raises when
    missing) with uninitialised weights: load a checkpoint (utils/checkpoint)
    or a state_dict (weights.py) before use."""
    if net_type != "unet_3D":
        raise ValueError(f"net_type {net_type!r} is not ported yet (unet_3D only)")
    cfg = UNet3DConfig(in_channels=in_chns, n_classes=class_num, scale_factor=int(scaler),
                       layout=layout)
    return UNet3D(cfg).to(resolve_device(device)).eval()
