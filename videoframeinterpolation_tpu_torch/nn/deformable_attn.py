"""Deformable cross-attention block (counterpart of ``videoframeinterpolation_tpu/nn/deformable_attn.py``).

For each query pixel of the intermediate frame, the block samples
``n_samples`` deformable locations per offset set from each source frame
(flow-seeded, tanh-bounded residual offsets) and attends over the
``2 * n_samples`` sampled values. Both source frames ride the batch axis
(2B) through the movement extractor, the offset predictor and the sampler.

The sampler is the hand-written CUDA kernel
:func:`..kernels.window_sample.deformable_sample` (its plain version on the
CPU). Offsets are pixels in both axes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.window_sample import _grouped_deformable_sample, deformable_sample
from ..ops import bwarp, scale_resize
from .blocks import (ConvPReLU, Dense, FeedForward, HalfChannelConv5ResBlock, conv,
                     conv_transpose_x2)

__all__ = ["SampleAttention", "CrossDeformableAttentionBlock", "_grouped_deformable_sample"]


class SampleAttention(nn.Module):
    """Per-pixel attention over S sampled key/values.

    Query ``(B, H, W, C)``; key/value ``(B, S, H*W, C)``. Head width
    ``hc = out_features / n_heads``, scale ``hc ** -0.5``. As in JAX, both
    contractions take their operands in the compute dtype and sum in fp32
    (products of bf16 values are exact in fp32), the softmax over S runs in
    fp32, and the attention weights and the output are rounded to the
    compute dtype.
    """

    def __init__(self, features: int, out_features: int, n_samples: int, n_heads: int):
        super().__init__()
        self.out_features, self.n_samples, self.n_heads = out_features, n_samples, n_heads
        self.q_proj = Dense(features, out_features)
        self.k_proj = Dense(features, out_features)
        self.v_proj = Dense(features, out_features)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = q.shape
        nh = self.n_heads
        hc = self.out_features // nh
        qp = self.q_proj(q).reshape(B, H * W, nh, hc)
        kp = self.k_proj(kv).reshape(B, self.n_samples, H * W, nh, hc)
        vp = self.v_proj(kv).reshape(B, self.n_samples, H * W, nh, hc)
        attn = torch.einsum("bnhc,bsnhc->bnhs", qp.float(), kp.float()) * hc ** -0.5
        attn = torch.softmax(attn, dim=-1).to(vp.dtype)
        out = torch.einsum("bnhs,bsnhc->bnhc", attn.float(), vp.float())
        return out.reshape(B, H, W, self.out_features).to(q.dtype)


class CrossDeformableAttentionBlock(nn.Module):
    """Deformable cross-attention over both source frames, with optional
    next-level flow prediction. The default path only: ``attn_stride > 1``,
    ``window_sampling``, ``movement_nf`` and ``ref_offset_units`` raise."""

    def __init__(self, features: int, out_features: int, n_samples: int = 9,
                 n_groups: int = 12, n_heads: int = 12, mlp_ratio: float = 2.0,
                 offset_scale: float = 2.0, pred_res_flow: bool = True,
                 window_sampling: bool = False, shared_offsets: bool = False,
                 attn_stride: int = 1, movement_nf: int | None = None,
                 ref_offset_units: bool = False):
        super().__init__()
        for name, value, default in (("attn_stride", attn_stride, 1),
                                     ("window_sampling", window_sampling, False),
                                     ("movement_nf", movement_nf, None),
                                     ("ref_offset_units", ref_offset_units, False)):
            if value != default:
                raise NotImplementedError(f"{name}={value!r} is not ported yet")
        c = features
        self.n_samples = n_samples
        self.offset_scale = offset_scale
        self.pred_res_flow = pred_res_flow
        self.n_offset_sets = 1 if shared_offsets else n_groups
        self.movement_conv1 = ConvPReLU(2 * c + 2, 2 * c)
        self.movement_conv2 = ConvPReLU(2 * c, c)
        self.movement_res = HalfChannelConv5ResBlock(c, c // 2)
        self.conv_res_offset = conv(c, self.n_offset_sets * n_samples * 2)
        if pred_res_flow:
            self.conv_res_flow = conv_transpose_x2(c, 2)
        self.attn = SampleAttention(c, out_features, 2 * n_samples, n_heads)
        self.mlp = FeedForward(out_features, int(out_features * mlp_ratio), out_features)

    def _movement_feats(self, feat_t, feat_x, ftx):
        h = torch.cat([feat_t, bwarp(feat_x, ftx), ftx], dim=-1)
        return self.movement_res(self.movement_conv2(self.movement_conv1(h)))

    def forward(self, feat_t, feat0, feat1, ft0, ft1):
        B = feat_t.shape[0]
        feat_b = torch.cat([feat0, feat1], dim=0)
        ft_b = torch.cat([ft0, ft1], dim=0)
        feat_t_b = torch.cat([feat_t, feat_t], dim=0)

        mv_b = self._movement_feats(feat_t_b, feat_b, ft_b)
        B2, H, W, _ = mv_b.shape
        res_b = self.offset_scale * torch.tanh(self.conv_res_offset(mv_b))
        res_b = res_b.reshape(B2, H, W, self.n_offset_sets, self.n_samples, 2)
        kv_b = deformable_sample(feat_b.contiguous(), ft_b.contiguous(),
                                 res_b.contiguous(), self.n_offset_sets)
        attended = self.attn(feat_t, torch.cat([kv_b[:B], kv_b[B:]], dim=1))
        out = attended + self.mlp(attended)
        if not self.pred_res_flow:
            return out
        # Next-level flows: transposed-conv residual on top of the 2x
        # upsampled, 2x magnified current flow.
        up_b = self.conv_res_flow(mv_b) + 2.0 * scale_resize(ft_b, 2.0)
        return out, up_b[:B], up_b[B:]
