"""Feature pyramid encoder (counterpart of ``videoframeinterpolation_tpu/nn/encoders.py``)."""

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
