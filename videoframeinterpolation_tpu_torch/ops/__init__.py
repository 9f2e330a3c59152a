"""Plain PyTorch compute ops of the serving and training paths."""

from .interp import grid_sample, resize_bilinear, resize_linear_antialias, scale_resize
from .softsplat import softsplat, softsplat_raw
from .warp import bwarp, fwarp, fwarp_mframes, fwarp_using_two_frames
from .dcn import deform_conv2d
from .pixelshuffle import pixel_shuffle
from .losses import (charbonnier_ada, charbonnier_l1, geometry_loss, get_robust_weight,
                     ternary_loss)

__all__ = [
    "grid_sample",
    "resize_bilinear",
    "resize_linear_antialias",
    "scale_resize",
    "softsplat",
    "softsplat_raw",
    "bwarp",
    "fwarp",
    "fwarp_mframes",
    "fwarp_using_two_frames",
    "deform_conv2d",
    "pixel_shuffle",
    "charbonnier_ada",
    "charbonnier_l1",
    "geometry_loss",
    "get_robust_weight",
    "ternary_loss",
]
