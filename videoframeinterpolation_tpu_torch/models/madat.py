"""MADAT (counterpart of ``videoframeinterpolation_tpu/models/madat.py``).

Motion from attention at 1/8, then motion-aware deformable attention
decoding at 1/4 and 1/2:

  1/2, 1/4, 1/8  a plain conv pyramid (``channels``, ``depths``) on both
       frames, normalised by one scalar mean per pair
  1/8  :class:`..nn.madat.InterFrameAttention` on both frames: attended
       features and motion per direction; ``motion2flow`` of the motion
       times ``t`` (``1 - t``) gives the flows to splat both frames'
       features to ``t`` (:func:`..ops.fwarp_using_two_frames`, unit
       metrics); ``motions2bwarpflow`` gives the flows from ``t``; a
       self-attention over the level propagates the feature and both flows
  1/4, 1/2  a ConvTranspose query of ``[bwarp(f0), feat, bwarp(f1)]``, the
       flows upsampled 2x and magnified 2x, a
       :class:`..nn.madat.DATWithMotionEstimation` block (G 4, then G 8; S
       9; one sampler launch for both frames), ``motion2flow`` of its
       motion as the flows' residuals, and the level's self-attention
  1/1  a UNet fuses both frames warped along the flows upsampled 2x with
       the three levels' features -> clip(rgb + mean, 0, 1) in fp32

Module and parameter names are flax's: the layers of ``motions2bwarpflow``
and ``motion2flow`` sit at the top of the tree (``m2b1``..``m2b3``,
``m2f1``..``m2f3``) beside ``encoder``, ``corr``, ``self_attn1..3``,
``query_builder1..2``, ``decoder1..2`` and ``rgb_builder``. One shared
``motion2flow`` head serves the 1/8 flows and both levels' residuals
(JAX projects every level's motion to ``motion_dim``).

``forward(..., train=True)`` also returns JAX's intermediates (``ft0``,
``ft1``: the flows from t at 1/1, 1/4 and 1/8, in the compute dtype), and
:func:`madat_loss` is the training loss (JAX ``models/madat.py:204-211``,
photometric only). The model has no staged ``encode``/``decode`` API:
:func:`.multi_t_apply` refuses it, as JAX's does.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..nn import ConvPReLU, conv, conv_transpose_x2
from ..nn.madat import DATWithMotionEstimation, FlowSelfAttnPropagation, InterFrameAttention
from ..ops import bwarp, charbonnier_l1, fwarp_using_two_frames, scale_resize, ternary_loss
from .base import norm_w_rgb_mean


def _up2(flow: torch.Tensor) -> torch.Tensor:
    """A flow resized 2x (bilinear, ``align_corners``) and magnified 2x."""
    return scale_resize(flow, 2.0) * 2.0


class FeatPyramid(nn.Module):
    """Per level ``i``: ``b{i}_down`` (stride 2) and ``depths[i] - 1``
    convs ``b{i}_c{j}``; returns the three levels, finest first."""

    def __init__(self, channels=(16, 32, 64), depths=(3, 3, 3)):
        super().__init__()
        prev = 3
        self.levels = []
        for i, (c, d) in enumerate(zip(channels, depths)):
            names = [f"b{i}_down"] + [f"b{i}_c{j}" for j in range(d - 1)]
            self.add_module(names[0], ConvPReLU(prev, c, stride=2))
            for name in names[1:]:
                self.add_module(name, ConvPReLU(c, c))
            self.levels.append(names)
            prev = c

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for names in self.levels:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


class UNetRGBBuilder(nn.Module):
    """The RGB head (JAX's reconstruction of the reference's missing UNet):
    both warped frames in, the decoder's features at 1/2, 1/4 and 1/8 fused
    on the way down, skips on the way up, a 3-channel conv out."""

    def __init__(self, channels=(16, 32, 64)):
        super().__init__()
        c1, c2, c3 = channels
        layers = OrderedDict([
            ("in", ConvPReLU(6, c1)), ("down1", ConvPReLU(c1, c1, stride=2)),
            ("fuse1", ConvPReLU(2 * c1, c1)), ("down2", ConvPReLU(c1, c2, stride=2)),
            ("fuse2", ConvPReLU(2 * c2, c2)), ("down3", ConvPReLU(c2, c3, stride=2)),
            ("fuse3", ConvPReLU(2 * c3, c3)), ("up2", conv_transpose_x2(c3, c2)),
            ("mix2", ConvPReLU(2 * c2, c2)), ("up1", conv_transpose_x2(c2, c1)),
            ("mix1", ConvPReLU(2 * c1, c1)), ("up0", conv_transpose_x2(c1, c1)),
            ("mix0", ConvPReLU(2 * c1, c1)), ("out", conv(c1, 3))])
        for name, layer in layers.items():
            self.add_module(name, layer)

    def forward(self, xt_from_x0: torch.Tensor, xt_from_x1: torch.Tensor, feats_t) -> torch.Tensor:
        m = self._modules
        d0 = m["in"](torch.cat([xt_from_x0, xt_from_x1], dim=-1))
        d1 = m["fuse1"](torch.cat([m["down1"](d0), feats_t[0]], dim=-1))
        d2 = m["fuse2"](torch.cat([m["down2"](d1), feats_t[1]], dim=-1))
        d3 = m["fuse3"](torch.cat([m["down3"](d2), feats_t[2]], dim=-1))
        u2 = m["mix2"](torch.cat([m["up2"](d3), d2], dim=-1))
        u1 = m["mix1"](torch.cat([m["up1"](u2), d1], dim=-1))
        u0 = m["mix0"](torch.cat([m["up0"](u1), d0], dim=-1))
        return m["out"](u0)


class MADAT(nn.Module):
    def __init__(self, channels=(16, 32, 64), depths=(3, 3, 3), motion_dim: int = 64,
                 mlp_ratio: float = 2.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c3 = channels
        md = motion_dim
        self.compute_dtype = compute_dtype
        self.encoder = FeatPyramid(channels, depths)
        self.corr = InterFrameAttention(c3, md, mlp_ratio=mlp_ratio)
        self.m2b1 = ConvPReLU(2 * md + c3, md)
        self.m2b2 = ConvPReLU(md, md // 2)
        self.m2b3 = conv(md // 2, 4)
        self.m2f1 = ConvPReLU(md, md // 2)
        self.m2f2 = ConvPReLU(md // 2, md // 2)
        self.m2f3 = conv(md // 2, 2)
        self.self_attn3 = FlowSelfAttnPropagation(c3)
        self.query_builder2 = conv_transpose_x2(3 * c3, c2)
        self.decoder2 = DATWithMotionEstimation(c2, c2, n_samples=9, n_groups=4, n_heads=4,
                                                mlp_ratio=mlp_ratio, motion_dim=md)
        self.self_attn2 = FlowSelfAttnPropagation(c2)
        self.query_builder1 = conv_transpose_x2(3 * c2, c1)
        self.decoder1 = DATWithMotionEstimation(c1, c1, n_samples=9, n_groups=8, n_heads=8,
                                                mlp_ratio=mlp_ratio, motion_dim=md)
        self.self_attn1 = FlowSelfAttnPropagation(c1)
        self.rgb_builder = UNetRGBBuilder(channels)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be wider: fp32 master weights)."""
        return self.compute_dtype

    def motions2bwarpflow(self, x: torch.Tensor) -> torch.Tensor:
        return self.m2b3(self.m2b2(self.m2b1(x)))

    def motion2flow(self, x: torch.Tensor) -> torch.Tensor:
        return self.m2f3(self.m2f2(self.m2f1(x)))

    def _level(self, query_builder, decoder, self_attn, sa_feat, f_b, ft0, ft1, prev_b):
        """One decoder level on the pair's features ``f_b`` (2B, frame 0
        first) from the coarser level's feature, flows and source features
        ``prev_b``: ``(feature, ft0, ft1)`` after the level's
        self-attention."""
        B = sa_feat.shape[0]
        warped = bwarp(prev_b, torch.cat([ft0, ft1], dim=0))
        q = query_builder(torch.cat([warped[:B], sa_feat, warped[B:]], dim=-1))
        up0, up1 = _up2(ft0), _up2(ft1)
        feat, mt0, mt1 = decoder(q, f_b[:B], f_b[B:], up0, up1)
        res = self.motion2flow(torch.cat([mt0, mt1], dim=0))
        return self_attn(feat, up0 + res[:B], up1 + res[B:])

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                train: bool = False):
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 8, ``t
        (B, 1, 1, 1)``; returns the ``(B, H, W, 3)`` fp32 frame and, with
        ``train``, JAX's intermediates."""
        B = x0.shape[0]
        x0n, x1n, mean = norm_w_rgb_mean(x0, x1)
        x0n, x1n = x0n.to(self.dtype), x1n.to(self.dtype)
        tt = t.to(self.dtype)
        f_1, f_2, f_3 = self.encoder(torch.cat([x0n, x1n], dim=0))
        _, fh, fw, _ = f_3.shape

        attended, motion = self.corr(f_3[:B], f_3[B:])
        att0, att1 = attended[:B], attended[B:]
        motion_t = torch.cat([motion[:B] * tt, motion[B:] * (1.0 - tt)], dim=0)
        flows = self.motion2flow(motion_t)
        ones = att0.new_ones((B, fh, fw, 1))
        feat_t_3, _ = fwarp_using_two_frames(att0, flows[:B], tt, att1, flows[B:], 1.0 - tt,
                                             ones, ones)
        bflows = self.motions2bwarpflow(torch.cat([motion_t[:B], motion_t[B:], feat_t_3], dim=-1))
        sa_3, ft0_3, ft1_3 = self.self_attn3(feat_t_3, bflows[..., 0:2], bflows[..., 2:4])

        sa_2, ft0_2, ft1_2 = self._level(self.query_builder2, self.decoder2, self.self_attn2,
                                         sa_3, f_2, ft0_3, ft1_3, f_3)
        sa_1, ft0_1, ft1_1 = self._level(self.query_builder1, self.decoder1, self.self_attn1,
                                         sa_2, f_1, ft0_2, ft1_2, f_2)

        up_ft0_1, up_ft1_1 = _up2(ft0_1), _up2(ft1_1)
        warped = bwarp(torch.cat([x0n, x1n], dim=0), torch.cat([up_ft0_1, up_ft1_1], dim=0))
        rgb = self.rgb_builder(warped[:B], warped[B:], [sa_1, sa_2, sa_3])
        # JAX adds the mean (rounded to the compute dtype) in the compute
        # dtype and casts the sum to fp32; XLA drops that last rounding.
        pred = rgb.float() + mean.to(rgb.dtype).float()
        pred = torch.minimum(torch.maximum(pred, pred.new_zeros(())), pred.new_ones(()))
        if not train:
            return pred
        return pred, {"ft0": [up_ft0_1, ft0_2, ft0_3], "ft1": [up_ft1_1, ft1_2, ft1_3]}


def madat_loss(pred: torch.Tensor, intermediates: dict, batch: dict):
    """MADAT's training loss, ``(total, log)`` with JAX's log keys:
    Charbonnier L1 plus census on the frame (the reference's photometric
    loss; the intermediates take no part)."""
    xt = batch["xt"]
    l1 = charbonnier_l1(pred - xt)
    census = ternary_loss(pred, xt)
    total = l1 + census
    return total, {"total_loss": total, "l1_loss": l1, "census_loss": census}
