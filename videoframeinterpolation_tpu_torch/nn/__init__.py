"""Neural network modules of the port's models (NHWC)."""

from .blocks import (
    ConvPReLU,
    FeedForward,
    HalfChannelConv5ResBlock,
    PReLU,
    ResBlock,
    ResBlocks,
    conv,
    conv_transpose_x2,
    sigmoid,
)
from .encoders import IFRNetEncoder, SameChannelResEncoder
from .dcn_layer import DeformableConv2d
from .query_builder import DCNInterFeatBuilderWithT
from .deformable_attn import CrossDeformableAttentionBlock, SampleAttention
from .generator import BasicResPixelShuffleGenerator
from .local_attn import LocalWindowCrossAttentionBlock, ShiftWindowSampleAttention

__all__ = [
    "ConvPReLU",
    "FeedForward",
    "HalfChannelConv5ResBlock",
    "PReLU",
    "ResBlock",
    "ResBlocks",
    "conv",
    "conv_transpose_x2",
    "sigmoid",
    "IFRNetEncoder",
    "SameChannelResEncoder",
    "DeformableConv2d",
    "DCNInterFeatBuilderWithT",
    "CrossDeformableAttentionBlock",
    "SampleAttention",
    "BasicResPixelShuffleGenerator",
    "LocalWindowCrossAttentionBlock",
    "ShiftWindowSampleAttention",
]
