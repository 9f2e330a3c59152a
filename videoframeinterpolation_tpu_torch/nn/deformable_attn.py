"""Deformable cross-attention block (counterpart of ``videoframeinterpolation_tpu/nn/deformable_attn.py``).

For each query pixel of the intermediate frame, the block samples
``n_samples`` deformable locations per offset set from each source frame
(flow-seeded, tanh-bounded residual offsets) and attends over the
``2 * n_samples`` sampled values. Both source frames ride the batch axis
(2B) through the movement extractor, the offset predictor and the sampler.

The sampler is the hand-written CUDA kernel
:func:`..kernels.window_sample.deformable_sample` (its plain version on the
CPU), on every path: ``window_sampling``, JAX's XLA formulation of the same
function for the TPU (``videoframeinterpolation_tpu/ops/windowed.py``),
takes it too. Offsets are pixels in both axes, or with ``ref_offset_units``
the reference's x units of a quarter pixel. With ``attn_stride`` 2 the
block runs on a query grid pooled 2x2 and samples the full-resolution
features (the kernel's strided query grid).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.window_sample import _grouped_deformable_sample, deformable_sample
from ..ops import bwarp, scale_resize
from .blocks import (ConvPReLU, Dense, FeedForward, HalfChannelConv5ResBlock, avg_pool, conv,
                     conv_transpose_x2, zero_init)

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
    next-level flow prediction, and the JAX block's variants:

    * ``movement_nf``: the movement extractor's width (``2 * movement_nf``
      after its first conv); the offset and flow heads read it.
    * ``attn_stride`` 2: movement extractor, offsets, sampling, attention and
      MLP on the 2x2-pooled query grid, sampling the full-resolution
      features; back to full resolution through ``attn_upsample`` (a
      transposed conv) plus ``conv_detail`` (a zero-initialised 3x3 conv of
      the full-resolution query). Needs ``pred_res_flow=False``.
    * ``ref_offset_units``: the summed offset times ``(0.25, 1)`` before the
      sampler, the reference's x units; ignored on a strided grid, as in JAX.
    * ``window_sampling``: JAX's other formulation of the same sampler, with
      the same parameters; here the same kernel.

    JAX's refusals are kept: ``attn_stride`` other than 1 or 2, a strided
    block with ``pred_res_flow`` or ``window_sampling``, ``ref_offset_units``
    with ``window_sampling``, and level dimensions a stride does not divide
    (at the call) raise ``ValueError``."""

    def __init__(self, features: int, out_features: int, n_samples: int = 9,
                 n_groups: int = 12, n_heads: int = 12, mlp_ratio: float = 2.0,
                 offset_scale: float = 2.0, pred_res_flow: bool = True,
                 window_sampling: bool = False, shared_offsets: bool = False,
                 attn_stride: int = 1, movement_nf: int | None = None,
                 ref_offset_units: bool = False):
        super().__init__()
        if attn_stride not in (1, 2):
            raise ValueError(f"attn_stride must be 1 or 2, got {attn_stride}")
        if attn_stride > 1 and pred_res_flow:
            raise ValueError("attn_stride > 1 requires pred_res_flow=False")
        if attn_stride > 1 and window_sampling:
            raise ValueError("attn_stride > 1 is incompatible with window_sampling")
        if window_sampling and ref_offset_units:
            raise ValueError("ref_offset_units is not supported with window_sampling")
        c = features
        mc = movement_nf or c
        self.n_samples = n_samples
        self.offset_scale = offset_scale
        self.pred_res_flow = pred_res_flow
        self.attn_stride = attn_stride
        self.ref_offset_units = ref_offset_units
        self.n_offset_sets = 1 if shared_offsets else n_groups
        self.movement_conv1 = ConvPReLU(2 * c + 2, 2 * mc)
        self.movement_conv2 = ConvPReLU(2 * mc, mc)
        self.movement_res = HalfChannelConv5ResBlock(mc, mc // 2)
        self.conv_res_offset = conv(mc, self.n_offset_sets * n_samples * 2, kernel_init=zero_init)
        if pred_res_flow:
            self.conv_res_flow = conv_transpose_x2(mc, 2)
        self.attn = SampleAttention(c, out_features, 2 * n_samples, n_heads)
        self.mlp = FeedForward(out_features, int(out_features * mlp_ratio), out_features)
        if attn_stride > 1:
            self.attn_upsample = conv_transpose_x2(out_features, out_features)
            self.conv_detail = conv(c, out_features, kernel_init=zero_init)

    def _movement(self, feat_t, warped, ftx):
        h = torch.cat([feat_t, warped, ftx], dim=-1)
        return self.movement_res(self.movement_conv2(self.movement_conv1(h)))

    def _res_offsets(self, mv_b):
        B2, H, W, _ = mv_b.shape
        res_b = self.offset_scale * torch.tanh(self.conv_res_offset(mv_b))
        return res_b.reshape(B2, H, W, self.n_offset_sets, self.n_samples, 2).contiguous()

    def forward(self, feat_t, feat0, feat1, ft0, ft1):
        B = feat_t.shape[0]
        feat_b = torch.cat([feat0, feat1], dim=0)
        ft_b = torch.cat([ft0, ft1], dim=0)
        feat_t_b = torch.cat([feat_t, feat_t], dim=0)
        if self.attn_stride > 1:
            return self._strided_forward(feat_t, feat_t_b, feat_b, ft_b)

        mv_b = self._movement(feat_t_b, bwarp(feat_b, ft_b), ft_b)
        res_b = self._res_offsets(mv_b)
        if self.ref_offset_units:
            # JAX sums in the compute dtype and scales (XLA rounds the bf16
            # sum before the scale); the kernel then adds a zero flow.
            off_b = (res_b + ft_b[:, :, :, None, None, :]) * res_b.new_tensor([0.25, 1.0])
            kv_b = deformable_sample(feat_b.contiguous(), torch.zeros_like(ft_b), off_b,
                                     self.n_offset_sets)
        else:
            kv_b = deformable_sample(feat_b.contiguous(), ft_b.contiguous(), res_b,
                                     self.n_offset_sets)
        attended = self.attn(feat_t, torch.cat([kv_b[:B], kv_b[B:]], dim=1))
        out = attended + self.mlp(attended)
        if not self.pred_res_flow:
            return out
        # Next-level flows: transposed-conv residual on top of the 2x
        # upsampled, 2x magnified current flow.
        up_b = self.conv_res_flow(mv_b) + 2.0 * scale_resize(ft_b, 2.0)
        return out, up_b[:B], up_b[B:]

    def _strided_forward(self, feat_t, feat_t_b, feat_b, ft_b):
        """The block on the ``(H/s, W/s)`` query grid (JAX
        ``_strided_forward``): flows stay in the level's pixel units, so the
        pooled ``bwarp`` divides them by the stride and the offsets do not."""
        s = self.attn_stride
        B, H, W = feat_t.shape[:3]
        if H % s or W % s:
            raise ValueError(f"attn_stride={s} requires level dims divisible by it; "
                             f"got {H}x{W}")
        feat_b_c, ft_b_c, feat_t_b_c = avg_pool(feat_b, s), avg_pool(ft_b, s), avg_pool(feat_t_b, s)
        mv_b = self._movement(feat_t_b_c, bwarp(feat_b_c, ft_b_c / float(s)), ft_b_c)
        kv_b = deformable_sample(feat_b.contiguous(), ft_b_c.contiguous(),
                                 self._res_offsets(mv_b), self.n_offset_sets, stride=s)
        attended = self.attn(feat_t_b_c[:B], torch.cat([kv_b[:B], kv_b[B:]], dim=1))
        out_c = attended + self.mlp(attended)
        return self.attn_upsample(out_c) + self.conv_detail(feat_t)
