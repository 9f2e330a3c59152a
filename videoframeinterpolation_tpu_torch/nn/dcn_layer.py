"""Flow-seeded modulated deformable conv layer (counterpart of ``videoframeinterpolation_tpu/nn/dcn_layer.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import bwarp, deform_conv2d
from .blocks import ConvPReLU, conv, zero_init


class DeformableConv2d(nn.Module):
    """DCNv2 whose taps start at a predicted flow; returns
    ``(features, offset_flow)``.

    Offsets are ``2 * tanh(res) + flow`` in the ``(B, H, W, G, K*K, (dx, dy))``
    layout, the mask is a sigmoid, and ``om_out``'s channels are ordered
    ``G x 3 x K*K`` (dx residuals, dy residuals, mask). ``om_out`` starts at
    zero and the grouped ``weight`` at ``U(+-1/sqrt(Cin/G * K*K))``, the
    per-group fan-in, as in JAX (``nn/dcn_layer.py:56,123``).
    """

    def __init__(self, in_features: int, features: int, movement_features: int,
                 kernel_size: int = 3, padding: int = 1, groups: int = 8):
        super().__init__()
        G, KK = groups, kernel_size * kernel_size
        self.groups, self.kernel_size, self.padding = groups, kernel_size, padding
        self.offset_flow_conv = conv(movement_features, 2)
        self.om1 = ConvPReLU(in_features + movement_features + 2, in_features)
        self.om2 = ConvPReLU(in_features, in_features)
        self.om_out = conv(in_features, G * 3 * KK, kernel_init=zero_init)
        bound = (1.0 / (in_features // G * KK)) ** 0.5
        self.weight = nn.Parameter(
            torch.empty(G, KK, in_features // G, features // G).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, movement_feat: torch.Tensor):
        B, H, W, _ = x.shape
        G, KK = self.groups, self.kernel_size * self.kernel_size
        # Where the JAX layer casts the result of a bias or offset add to
        # fp32 (bwarp's flow, deform_conv2d's offsets), XLA takes that add in
        # fp32 without rounding it to the compute dtype first; so does this.
        flow = self.offset_flow_conv.product(movement_feat)
        bias = self.offset_flow_conv.bias.to(flow.dtype)
        offset_flow = flow + bias
        feat_t_from_x = bwarp(x, flow.float() + bias.float())
        h = torch.cat([feat_t_from_x, movement_feat, offset_flow], dim=-1)
        om = self.om_out(self.om2(self.om1(h))).reshape(B, H, W, G, 3, KK)
        res_offset = 2.0 * torch.tanh(torch.stack([om[..., 0, :], om[..., 1, :]], dim=-1))
        offset = res_offset.float() + offset_flow.float()[:, :, :, None, None, :]
        # jax.nn.sigmoid's steps, each rounded to the compute dtype.
        mask = 1.0 / (1.0 + torch.exp(-om[..., 2, :]))
        out = deform_conv2d(x, offset, mask, self.weight, self.bias,
                            kernel_size=self.kernel_size, padding=self.padding)
        return out, offset_flow
