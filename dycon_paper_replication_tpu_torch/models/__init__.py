"""Models: the three-head UNet3D (with optional ASPP) and VNet, plain and
fold-2, and their factory."""

from .aspp import ASPP3D
from .factory import build_model, model_config, net_factory_3d
from .unet3d import UNet3D, UNet3DConfig
from .vnet import VNet, VNetConfig

__all__ = ["ASPP3D", "UNet3D", "UNet3DConfig", "VNet", "VNetConfig", "build_model",
           "model_config", "net_factory_3d"]
