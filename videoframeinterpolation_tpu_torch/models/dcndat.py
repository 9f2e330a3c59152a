"""DCNDAT (counterpart of ``videoframeinterpolation_tpu/models/dcndat.py``).

The flagship's closest ancestor: deformable attention whose sampling
offsets and mask also drive a deformable convolution of each source frame
(its nine taps are the attention's nine samples), which builds an enhanced
query blended 1x1 with the incoming one.

  1/16  shared 4-level encoder on both frames (constant ``nf`` channels)
        -> t-conditioned query builder with ONE deformable conv for both
           directions (``1 - t`` for the reverse one): (feat_t, ft0, ft1)
  1/8   ConvTranspose joint upsample of [feat || ft0 || ft1]
        -> DCNDAT block level 3 (G 8, heads 8, S 9)
  1/4   -> DCNDAT block level 2 (G 4, heads 4, S 9)
  1/2   -> DCNDAT block level 1 (G 4, heads 4, S 9, no flow)
  1/1   PixelShuffle generator -> clamp(rgb + mean, 0, 1)

Module and parameter names are the flax ones (``cnn_encoder``,
``dcn_feat_t_builder.dcn``, ``dat_scale3.query_enhancer.weight``, ...).
Each block runs both source frames on the batch axis (2B), so it launches
the sampler (:func:`..kernels.window_sample.deformable_sample`) once per
level: three launches per forward, and in training three backward
launches. The deformable convolutions are the plain
:func:`..ops.deform_conv2d`.

``forward(..., train=True)`` also returns JAX's intermediates
(``feat_t_3``, ``feat_t_4``, ``flows0``, ``flows1``, ``mean``), and
:func:`dcndat_loss` is the training loss (JAX ``models/dcndat.py:243-291``).
The model has no staged ``encode``/``decode`` API: :func:`.multi_t_apply`
refuses it, as JAX's does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.window_sample import deformable_sample
from ..nn import (BasicResPixelShuffleGenerator, ConvPReLU, DeformableConv2d, FeedForward,
                  HalfChannelConv5ResBlock, SameChannelResEncoder, SampleAttention, conv,
                  conv_transpose_x2, sigmoid)
from ..nn.blocks import Dense, zero_init
from ..ops import (bwarp, charbonnier_ada, charbonnier_l1, deform_conv2d, geometry_loss,
                   get_robust_weight, resize_bilinear, scale_resize, ternary_loss)
from .base import norm_w_rgb_mean


def lecun_normal_init(w: torch.Tensor, fan_in: int) -> None:
    """flax's default ``Dense`` kernel init, ``lecun_normal``: a normal
    truncated at two standard deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


class DeformableConv2dGivenOffset(nn.Module):
    """A modulated deformable conv whose offsets ``(B, H, W, G, K*K, 2)``
    and mask logits ``(B, H, W, G, K*K)`` the caller supplies. The grouped
    ``weight`` ``(G, K*K, Cin/G, Cout/G)`` is drawn ``U(+-(Cin/G *
    K*K)^-1/2)`` and the bias starts at zero, as in JAX. The mask is
    :func:`..nn.sigmoid` of the logits (XLA's per-step rounding)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1, groups: int = 8):
        super().__init__()
        G, KK = groups, kernel_size * kernel_size
        self.kernel_size, self.padding = kernel_size, padding
        bound = (1.0 / (in_features // G * KK)) ** 0.5
        self.weight = nn.Parameter(
            torch.empty(G, KK, in_features // G, features // G).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, offset: torch.Tensor,
                mask_logits: torch.Tensor) -> torch.Tensor:
        KK = self.kernel_size ** 2
        if offset.shape[4] != KK:
            raise ValueError(f"{offset.shape[4]} offsets per group do not fit a "
                             f"{self.kernel_size}x{self.kernel_size} kernel: n_samples must "
                             "be kernel_size ** 2")
        return deform_conv2d(x, offset, sigmoid(mask_logits), self.weight, self.bias,
                             kernel_size=self.kernel_size, padding=self.padding)


class SharedDCNQueryBuilder(nn.Module):
    """The t-conditioned coarse query builder with one deformable conv for
    both directions: ``(f0, f1, t)`` and ``(f1, f0, 1 - t)`` go through the
    same motion convs and the same ``dcn``, batched on 2B. Returns
    ``(feat_t, ft0, ft1)``."""

    def __init__(self, features: int):
        super().__init__()
        nf = features
        self.motion1 = ConvPReLU(2 * nf + 1, nf)
        self.motion2 = ConvPReLU(nf, nf)
        self.dcn = DeformableConv2d(nf, nf, nf)
        self.blend1 = ConvPReLU(2 * nf, nf)
        self.blend2 = conv(nf, nf)

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor, t: torch.Tensor):
        B, H, W, _ = feat0.shape
        t_map = t.to(feat0.dtype).expand(B, H, W, 1)
        h = torch.cat([torch.cat([feat0, feat1, t_map], dim=-1),
                       torch.cat([feat1, feat0, 1.0 - t_map], dim=-1)], dim=0)
        ft_from, ft = self.dcn(torch.cat([feat0, feat1], dim=0), self.motion2(self.motion1(h)))
        h = self.blend1(torch.cat([ft_from[:B], ft_from[B:]], dim=-1))
        return self.blend2(h), ft[:B], ft[B:]


class DCNDATBlock(nn.Module):
    """Deformable attention with DCN query enhancement (JAX ``DCNDATBlock``).

    Per source frame (both on 2B): the movement features of ``[feat_t,
    bwarp(feat_x, ftx), ftx]``; one conv predicts, per group and sample,
    the residual offsets (``offset_scale * tanh``) and the mask logits; the
    offsets are the residual plus ``ftx``. They drive the deformable conv
    that builds each frame's enhanced query (the ``query_blender`` Dense
    over ``[enh0, feat_t, enh1]`` makes the query) and the sampler, whose
    ``2 * n_samples`` keys the query attends to.

    XLA takes the compute dtype's ``res + ftx`` in fp32 in both of its
    consumers, each of which casts it to fp32 (``tests/test_torch_dcndat.py``
    holds that): the sampler adds the two in fp32 itself, and the deformable
    conv gets the fp32 sum."""

    def __init__(self, features: int, out_features: int, n_samples: int = 9,
                 n_groups: int = 8, n_heads: int = 8, mlp_ratio: float = 2.0,
                 offset_scale: float = 2.0, pred_res_flow: bool = True):
        super().__init__()
        c = features
        self.n_samples, self.n_groups = n_samples, n_groups
        self.offset_scale = offset_scale
        self.pred_res_flow = pred_res_flow
        self.movement_conv1 = ConvPReLU(2 * c + 2, 2 * c)
        self.movement_conv2 = ConvPReLU(2 * c, c)
        self.movement_res = HalfChannelConv5ResBlock(c, c // 2)
        self.conv_res_offset_mask = conv(c, n_groups * n_samples * 3, kernel_init=zero_init)
        if pred_res_flow:
            self.conv_res_flow = conv_transpose_x2(c, 2)
        self.query_enhancer = DeformableConv2dGivenOffset(c, out_features, groups=n_groups)
        self.query_blender = Dense(2 * out_features + c, c)
        lecun_normal_init(self.query_blender.weight, 2 * out_features + c)
        self.attn = SampleAttention(c, out_features, 2 * n_samples, n_heads)
        self.mlp = FeedForward(out_features, int(out_features * mlp_ratio), out_features)

    def _enhance_and_sample(self, feat_b, ft_b, mv_b):
        """The two consumers of the offsets, on 2B: the enhanced query of
        each frame (the deformable conv) and its sampled keys ``(2B, S,
        H*W, C)`` (the sampler)."""
        B2, H, W, _ = mv_b.shape
        om = self.conv_res_offset_mask(mv_b).reshape(B2, H, W, self.n_groups, 3, self.n_samples)
        res_b = self.offset_scale * torch.tanh(torch.stack([om[..., 0, :], om[..., 1, :]], dim=-1))
        offsets = res_b.float() + ft_b.float()[:, :, :, None, None, :]
        enh_b = self.query_enhancer(feat_b, offsets, om[..., 2, :])
        kv_b = deformable_sample(feat_b.contiguous(), ft_b.contiguous(), res_b, self.n_groups)
        return enh_b, kv_b

    def forward(self, feat_t, feat0, feat1, ft0, ft1):
        B = feat_t.shape[0]
        feat_b = torch.cat([feat0, feat1], dim=0)
        ft_b = torch.cat([ft0, ft1], dim=0)
        h = torch.cat([torch.cat([feat_t, feat_t], dim=0), bwarp(feat_b, ft_b), ft_b], dim=-1)
        mv_b = self.movement_res(self.movement_conv2(self.movement_conv1(h)))

        enh_b, kv_b = self._enhance_and_sample(feat_b, ft_b, mv_b)
        query = self.query_blender(torch.cat([enh_b[:B], feat_t, enh_b[B:]], dim=-1))
        attended = self.attn(query, torch.cat([kv_b[:B], kv_b[B:]], dim=1))
        out = attended + self.mlp(attended)
        if not self.pred_res_flow:
            return out
        up_b = self.conv_res_flow(mv_b) + 2.0 * scale_resize(ft_b, 2.0)
        return out, up_b[:B], up_b[B:]


class DCNDAT(nn.Module):
    def __init__(self, nf: int = 64, enc_res_blocks: int = 5, dec_res_blocks: int = 10,
                 mlp_ratio: float = 2.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nf = nf
        self.compute_dtype = compute_dtype
        self.cnn_encoder = SameChannelResEncoder(nf, enc_res_blocks)
        self.dcn_feat_t_builder = SharedDCNQueryBuilder(nf)
        self.query_builder3 = conv_transpose_x2(nf + 4, nf + 4)
        self.dat_scale3 = DCNDATBlock(nf, nf, n_samples=9, n_groups=8, n_heads=8,
                                      mlp_ratio=mlp_ratio)
        self.query_builder2 = conv_transpose_x2(nf, nf)
        self.dat_scale2 = DCNDATBlock(nf, nf, n_samples=9, n_groups=4, n_heads=4,
                                      mlp_ratio=mlp_ratio)
        self.query_builder1 = conv_transpose_x2(nf, nf)
        self.dat_scale1 = DCNDATBlock(nf, nf, n_samples=9, n_groups=4, n_heads=4,
                                      mlp_ratio=mlp_ratio, pred_res_flow=False)
        self.generator = BasicResPixelShuffleGenerator(nf, dec_res_blocks)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be wider: fp32 master weights)."""
        return self.compute_dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The encoder pyramid of one mean-normalised frame (the geometry
        loss encodes the ground truth with it), in the compute dtype."""
        return self.cnn_encoder(x.to(self.dtype))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                train: bool = False):
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 16, ``t
        (B, 1, 1, 1)``; returns the ``(B, H, W, 3)`` fp32 frame at t and,
        with ``train``, JAX's intermediates: ``feat_t_3``, ``feat_t_4``,
        ``flows0`` and ``flows1`` (levels 1-4, finest first, in each level's
        pixel units) and ``mean``."""
        nf = self.nf
        B = x0.shape[0]
        x0n, x1n, mean = norm_w_rgb_mean(x0, x1)
        feats = self.encode(torch.cat([x0n, x1n], dim=0))
        f0 = [f[:B] for f in feats]
        f1 = [f[B:] for f in feats]

        feat_t_4, ft0_4, ft1_4 = self.dcn_feat_t_builder(f0[3], f1[3], t)
        up3 = self.query_builder3(torch.cat([feat_t_4, ft0_4, ft1_4], dim=-1))
        feat_t_3 = up3[..., :nf]
        ft0_3, ft1_3 = up3[..., nf:nf + 2], up3[..., nf + 2:nf + 4]

        att3, ft0_2, ft1_2 = self.dat_scale3(feat_t_3, f0[2], f1[2], ft0_3, ft1_3)
        att2, ft0_1, ft1_1 = self.dat_scale2(self.query_builder2(att3), f0[1], f1[1],
                                             ft0_2, ft1_2)
        att1 = self.dat_scale1(self.query_builder1(att2), f0[0], f1[0], ft0_1, ft1_1)
        pred = self.generator(att1, mean).float()
        if not train:
            return pred
        return pred, {"feat_t_3": feat_t_3, "feat_t_4": feat_t_4,
                      "flows0": [ft0_1, ft0_2, ft0_3, ft0_4],
                      "flows1": [ft1_1, ft1_2, ft1_3, ft1_4], "mean": mean}


def dcndat_loss(pred: torch.Tensor, intermediates: dict, batch: dict, gt_feats,
                geo_lambda: float | None = 0.01, distill_lambda: float | None = 0.01):
    """DCNDAT's training loss, ``(total, log)`` with JAX's log keys:
    Charbonnier L1 and census on the frame; ``geo_lambda`` times the
    geometry loss of ``feat_t_3`` and ``feat_t_4`` against levels 3 and 4
    of ``gt_feats``, the encoder pyramid of the mean-normalised ground truth
    (``model.encode(xt - mean)``); and ``distill_lambda`` times the
    robust-weighted Charbonnier of levels 2-4's flows, each upsampled to
    full resolution and magnified by its scale, against the pseudo-GT flows,
    the weights from level 1's (detached). A ``None`` lambda leaves its term
    out; the distillation needs ``f0x`` and ``f1x`` in the batch."""
    xt = batch["xt"]
    l1 = charbonnier_l1(pred - xt)
    census = ternary_loss(pred, xt)
    total = l1 + census
    log = {"l1_loss": l1, "census_loss": census}
    if geo_lambda is not None:
        geo = geo_lambda * (
            geometry_loss(intermediates["feat_t_3"].float(), gt_feats[2].float())
            + geometry_loss(intermediates["feat_t_4"].float(), gt_feats[3].float()))
        total = total + geo
        log["geometry_loss"] = geo
    if distill_lambda is not None:
        if "f0x" not in batch:
            # JAX's loss fails here with KeyError 'f0x'.
            raise ValueError("DCNDAT's flow distillation (distill_lambda) needs the batch's "
                             "pseudo-GT flows f0x and f1x: train on data_name Vimeo90KwFlow "
                             "(configs/archive/DCNDAT.yaml names Vimeo90K, whose batches "
                             "carry none), or set distill_lambda to null")
        ft0, ft1 = batch["f0x"], batch["f1x"]

        def up(f, s):
            H, W = f.shape[1:3]
            return resize_bilinear(f.float(), (H * s, W * s), align_corners=True) * float(s)

        f0, f1 = intermediates["flows0"], intermediates["flows1"]
        w0 = get_robust_weight(up(f0[0], 2), ft0, beta=0.3)
        w1 = get_robust_weight(up(f1[0], 2), ft1, beta=0.3)
        distill = charbonnier_ada(up(f0[1], 4) - ft0, w0)
        for i, s in ((1, 4), (2, 8), (3, 16)):
            if i > 1:
                distill = distill + charbonnier_ada(up(f0[i], s) - ft0, w0)
            distill = distill + charbonnier_ada(up(f1[i], s) - ft1, w1)
        distill = distill_lambda * distill
        total = total + distill
        log["flow_loss"] = distill
    log["total_loss"] = total
    return total, log
