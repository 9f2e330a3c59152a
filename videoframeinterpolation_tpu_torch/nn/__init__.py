"""Neural network modules of the serving path (NHWC)."""

from .blocks import (
    ConvPReLU,
    FeedForward,
    HalfChannelConv5ResBlock,
    PReLU,
    ResBlock,
    ResBlocks,
    conv,
    conv_transpose_x2,
)
from .encoders import SameChannelResEncoder
from .dcn_layer import DeformableConv2d
from .query_builder import DCNInterFeatBuilderWithT
from .deformable_attn import CrossDeformableAttentionBlock, SampleAttention
from .generator import BasicResPixelShuffleGenerator

__all__ = [
    "ConvPReLU",
    "FeedForward",
    "HalfChannelConv5ResBlock",
    "PReLU",
    "ResBlock",
    "ResBlocks",
    "conv",
    "conv_transpose_x2",
    "SameChannelResEncoder",
    "DeformableConv2d",
    "DCNInterFeatBuilderWithT",
    "CrossDeformableAttentionBlock",
    "SampleAttention",
    "BasicResPixelShuffleGenerator",
]
