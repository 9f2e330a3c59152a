"""Flagship model (counterpart of ``videoframeinterpolation_tpu/models/dat.py:DATwConstantnC``).

  1/16  shared 4-level encoder on both frames (constant ``nf`` channels)
        -> t-conditioned DCN query builder gives (feat_t, ft0, ft1)
  1/8   ConvTranspose joint upsample of [feat || ft0 || ft1]
        -> deformable attention level 3 (nG=4, nH=4, scale 2)
  1/4   -> deformable attention level 2 (nG=8, nH=8, scale 4)
  1/2   -> deformable attention level 1 (nG=8, nH=8, scale 8, no flow)
  1/1   PixelShuffle generator -> clamp(rgb + mean, 0, 1)

Inference only in this slice: ``forward`` returns the frame, and the
``train=True`` flow pyramids wait for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import (
    BasicResPixelShuffleGenerator,
    CrossDeformableAttentionBlock,
    DCNInterFeatBuilderWithT,
    SameChannelResEncoder,
    conv_transpose_x2,
)
from .base import norm_w_rgb_mean


class DATwConstantnC(nn.Module):
    def __init__(self, nf: int = 72, enc_res_blocks: int = 5, dec_res_blocks: int = 10,
                 mlp_ratio: float = 2.0, window_sampling: bool = False,
                 shared_offsets: bool | tuple = False, n_samples: tuple = (8, 16, 32),
                 attn_strides: tuple = (1, 1, 1), movement_nf: tuple | None = None,
                 ref_offset_units: bool = False):
        super().__init__()
        self.nf = nf
        so = shared_offsets
        so3, so2, so1 = (so, so, so) if isinstance(so, bool) else tuple(so)
        ns3, ns2, ns1 = n_samples
        st3, st2, st1 = attn_strides
        mv3, mv2, mv1 = movement_nf or (None, None, None)
        common = dict(mlp_ratio=mlp_ratio, window_sampling=window_sampling,
                      ref_offset_units=ref_offset_units)
        self.feature_encoder = SameChannelResEncoder(nf, enc_res_blocks)
        self.coarse_query_builder = DCNInterFeatBuilderWithT(nf)
        self.lv4_to_lv3 = conv_transpose_x2(nf + 4, nf + 4)
        self.dat_lv3 = CrossDeformableAttentionBlock(
            nf, nf, n_samples=ns3, n_groups=4, n_heads=4, offset_scale=2.0,
            shared_offsets=so3, attn_stride=st3, movement_nf=mv3, **common)
        self.lv3_to_lv2 = conv_transpose_x2(nf, nf)
        self.dat_lv2 = CrossDeformableAttentionBlock(
            nf, nf, n_samples=ns2, n_groups=8, n_heads=8, offset_scale=4.0,
            shared_offsets=so2, attn_stride=st2, movement_nf=mv2, **common)
        self.lv2_to_lv1 = conv_transpose_x2(nf, nf)
        self.dat_lv1 = CrossDeformableAttentionBlock(
            nf, nf, n_samples=ns1, n_groups=8, n_heads=8, offset_scale=8.0,
            pred_res_flow=False, shared_offsets=so1, attn_stride=st1,
            movement_nf=mv1, **common)
        self.pixel_generator = BasicResPixelShuffleGenerator(nf, dec_res_blocks)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the parameters."""
        return self.lv4_to_lv3.weight.dtype

    def encode(self, x0: torch.Tensor, x1: torch.Tensor):
        """The t-invariant stage: normalization (in the input's dtype) and the
        shared-weight feature pyramid on both frames batched together (2B),
        in the compute dtype; ``mean`` keeps the input's dtype."""
        x0n, x1n, mean = norm_w_rgb_mean(x0, x1)
        x0n, x1n = x0n.to(self.dtype), x1n.to(self.dtype)
        feats = self.feature_encoder(torch.cat([x0n, x1n], dim=0))
        return feats, mean

    def decode(self, feats, mean: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The t-dependent stage: query building, the deformable
        cross-attention pyramid and the pixel generator."""
        nf = self.nf
        B = feats[0].shape[0] // 2
        (f0_1, f1_1), (f0_2, f1_2), (f0_3, f1_3), (f0_4, f1_4) = (
            (f[:B], f[B:]) for f in feats)

        feat_t_4, ft0_4, ft1_4 = self.coarse_query_builder(f0_4, f1_4, t)
        up3 = self.lv4_to_lv3(torch.cat([feat_t_4, ft0_4, ft1_4], dim=-1))
        feat_t_3 = up3[..., :nf]
        ft0_3, ft1_3 = up3[..., nf:nf + 2], up3[..., nf + 2:nf + 4]

        attended_3, ft0_2, ft1_2 = self.dat_lv3(feat_t_3, f0_3, f1_3, ft0_3, ft1_3)
        query_2 = self.lv3_to_lv2(attended_3)
        attended_2, ft0_1, ft1_1 = self.dat_lv2(query_2, f0_2, f1_2, ft0_2, ft1_2)
        query_1 = self.lv2_to_lv1(attended_2)
        attended_1 = self.dat_lv1(query_1, f0_1, f1_1, ft0_1, ft1_1)
        return self.pixel_generator(attended_1, mean).float()

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 16,
        ``t (B, 1, 1, 1)``; returns the ``(B, H, W, 3)`` fp32 frame at t."""
        feats, mean = self.encode(x0, x1)
        return self.decode(feats, mean, t)
