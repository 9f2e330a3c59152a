"""Feature pyramid encoders (counterpart of ``videoframeinterpolation_tpu/nn/encoders.py``).

``SameChannelResEncoder`` is the DAT family's shared-weight pyramid;
``IFRNetEncoder`` is IFRNet's growing-channel one.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import ConvPReLU, ResBlocks


class SameChannelResEncoder(nn.Module):
    """4-level pyramid at 1/2, 1/4, 1/8 and 1/16 resolution, all ``nf`` channels."""

    def __init__(self, nf: int, n_res_blocks: int, in_features: int = 3):
        super().__init__()
        self.proj_in = ConvPReLU(in_features, nf)
        self.proj_down = ConvPReLU(nf, nf, stride=2)
        self.proj_res = ResBlocks(nf, n_res_blocks) if n_res_blocks > 0 else nn.Identity()
        for lv in ("l2", "l3", "l4"):
            setattr(self, f"{lv}_down", ConvPReLU(nf, nf, stride=2))
            setattr(self, f"{lv}_conv", ConvPReLU(nf, nf))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        feat1 = self.proj_res(self.proj_down(self.proj_in(x)))
        feat2 = self.l2_conv(self.l2_down(feat1))
        feat3 = self.l3_conv(self.l3_down(feat2))
        feat4 = self.l4_conv(self.l4_down(feat3))
        return feat1, feat2, feat3, feat4


class IFRNetEncoder(nn.Module):
    """4-level pyramid at 1/2 to 1/16 resolution, widths ``channels``
    (32/48/72/96 by default): per level a stride-2 ``ConvPReLU``
    (``p{i}_down``) and a stride-1 one (``p{i}_conv``)."""

    def __init__(self, channels=(32, 48, 72, 96), in_features: int = 3):
        super().__init__()
        for i, c in enumerate(channels, start=1):
            setattr(self, f"p{i}_down", ConvPReLU(in_features, c, stride=2))
            setattr(self, f"p{i}_conv", ConvPReLU(c, c))
            in_features = c
        self.levels = len(channels)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        feats = []
        for i in range(1, self.levels + 1):
            x = getattr(self, f"p{i}_conv")(getattr(self, f"p{i}_down")(x))
            feats.append(x)
        return tuple(feats)
