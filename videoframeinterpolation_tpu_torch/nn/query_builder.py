"""t-conditioned coarse query builder (counterpart of ``videoframeinterpolation_tpu/nn/query_builder.py``).

Builds the intermediate frame's 1/16-resolution feature from the two
coarsest source features. One set of motion convs serves both
``(f0, f1, t)`` and ``(f1, f0, 1 - t)``; two flow-seeded deformable convs
and a blending conv follow. Returns ``(feat_t, ft0, ft1)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import ConvPReLU, conv
from .dcn_layer import DeformableConv2d


class DCNInterFeatBuilderWithT(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        nf = features
        self.motion1 = ConvPReLU(2 * nf + 1, nf)
        self.motion2 = ConvPReLU(nf, nf)
        self.dcnt0 = DeformableConv2d(nf, nf, nf)
        self.dcnt1 = DeformableConv2d(nf, nf, nf)
        self.blend1 = ConvPReLU(2 * nf, nf)
        self.blend2 = conv(nf, nf)

    def _motion(self, a: torch.Tensor, b: torch.Tensor, t_map: torch.Tensor):
        return self.motion2(self.motion1(torch.cat([a, b, t_map], dim=-1)))

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor, t: torch.Tensor):
        B, H, W, _ = feat0.shape
        t_map = t.to(feat0.dtype).expand(B, H, W, 1)
        feat_t_from_0, ft0 = self.dcnt0(feat0, self._motion(feat0, feat1, t_map))
        feat_t_from_1, ft1 = self.dcnt1(feat1, self._motion(feat1, feat0, 1.0 - t_map))
        h = self.blend1(torch.cat([feat_t_from_0, feat_t_from_1], dim=-1))
        return self.blend2(h), ft0, ft1
