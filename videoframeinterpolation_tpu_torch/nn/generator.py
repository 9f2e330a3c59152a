"""Pixel generator (counterpart of ``videoframeinterpolation_tpu/nn/generator.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import pixel_shuffle
from .blocks import PReLU, ResBlocks, conv


class BasicResPixelShuffleGenerator(nn.Module):
    """N res blocks -> conv to 4*nf -> PixelShuffle(2) -> HR conv -> RGB;
    the output is ``clamp(rgb + mean, 0, 1)``, written as ``min(max(., 0), 1)``
    so that a value on a bound passes half its gradient, as ``jnp.clip``
    does."""

    def __init__(self, nf: int, n_res_blocks: int):
        super().__init__()
        self.reconstruction = ResBlocks(nf, n_res_blocks)
        self.upconv1 = conv(nf, nf * 4)
        self.prelu1 = PReLU(nf)
        self.hrconv = conv(nf, nf)
        self.prelu2 = PReLU(nf)
        self.conv_last = conv(nf, 3)

    def forward(self, feat: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        h = self.upconv1(self.reconstruction(feat))
        h = self.prelu1(pixel_shuffle(h, 2))
        h = self.prelu2(self.hrconv(h))
        h = self.conv_last(h)
        h = h + mean.to(h.dtype)
        return torch.minimum(torch.maximum(h, h.new_zeros(())), h.new_ones(()))
