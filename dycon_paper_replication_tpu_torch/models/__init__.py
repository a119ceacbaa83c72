"""Models: the three-head UNet3D, plain and fold-2, and its factory."""

from .factory import net_factory_3d
from .unet3d import UNet3D, UNet3DConfig

__all__ = ["UNet3D", "UNet3DConfig", "net_factory_3d"]
