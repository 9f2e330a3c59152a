"""Plain PyTorch compute ops of the serving path."""

from .interp import grid_sample, resize_bilinear, scale_resize
from .warp import bwarp
from .dcn import deform_conv2d
from .pixelshuffle import pixel_shuffle

__all__ = [
    "grid_sample",
    "resize_bilinear",
    "scale_resize",
    "bwarp",
    "deform_conv2d",
    "pixel_shuffle",
]
