"""DCNTrans v1 (counterpart of ``videoframeinterpolation_tpu/models/dcntrans.py``).

  1/8  shared 3-level encoder on both frames (constant ``nf`` channels)
       -> coarse query builder: shared motion convs, one deformable conv
          per direction (``dcn0t``, ``dcn1t``), a blend (no ``t``)
  1/4  ConvTranspose upsample, the sine position embedding added to the
       query and to both frames' features -> Swin decoder (8 deep, 8 heads,
       window 4)
  1/2  ConvTranspose upsample -> Swin decoder (8 deep, 4 heads, window 4)
  1/1  residual blocks and a PixelShuffle head -> clamp(rgb + mean, 0, 1)

v1 never reads ``t``: every instant of a pair gives the same frame. The
frames are normalised by their per-image, per-channel spatial mean (DAT's
by one scalar). Module and parameter names are the flax ones
(``dcn_builder.dcn0t``, ``decoder2.transformer.block3.attn.kv_proj``, ...).
No kernel of its own: the deformable convolutions are the plain
:func:`..ops.deform_conv2d`, the attention cuBLAS products
(:mod:`..nn.swin`).

``forward(..., train=True)`` also returns JAX's intermediates (``feat_t_3``,
``feat_t_2``: the query before ``decoder2``, ``f01_off``, ``f10_off``:
the DCNs' offset flows in fp32, ``mean``), and :func:`dcntrans_loss` is
the training loss (JAX ``models/dcntrans.py:161-191``). The model has no
staged ``encode``/``decode`` API: :func:`.multi_t_apply` refuses it, as
JAX's does. ``DCNTransFwarp`` (v2) needs ``DeformableConv2dWithFwarp``,
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import ConvPReLU, DeformableConv2d, PReLU, ResBlocks, conv, conv_transpose_x2
from ..nn.position import position_embedding_sine
from ..nn.swin import SwinDecoder
from ..ops import (charbonnier_ada, charbonnier_l1, geometry_loss, get_robust_weight,
                   pixel_shuffle, resize_bilinear, ternary_loss)


class DCNInterFeatBuilder(nn.Module):
    """The t-free coarse query builder: the motion features of ``[f0 || f1]``
    and ``[f1 || f0]`` (the same ``motion1``, ``motion2``, batched on 2B)
    drive ``dcn0t`` on frame 0 and ``dcn1t`` on frame 1; ``blend1`` and
    ``blend2`` make the query. Returns ``(query, f01, f10)``, the offset
    flows of the two deformable convs."""

    def __init__(self, features: int):
        super().__init__()
        nf = features
        self.motion1 = ConvPReLU(2 * nf, nf)
        self.motion2 = ConvPReLU(nf, nf)
        self.dcn0t = DeformableConv2d(nf, nf, nf)
        self.dcn1t = DeformableConv2d(nf, nf, nf)
        self.blend1 = ConvPReLU(2 * nf, nf)
        self.blend2 = conv(nf, nf)

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor):
        B = feat0.shape[0]
        m = self.motion2(self.motion1(torch.cat([torch.cat([feat0, feat1], dim=-1),
                                                 torch.cat([feat1, feat0], dim=-1)], dim=0)))
        ft0, f01 = self.dcn0t(feat0, m[:B])
        ft1, f10 = self.dcn1t(feat1, m[B:])
        return self.blend2(self.blend1(torch.cat([ft0, ft1], dim=-1))), f01, f10


class DCNTrans(nn.Module):
    def __init__(self, nf: int = 64, enc_res_blocks: int = 5, dec_res_blocks: int = 10,
                 mlp_ratio: float = 2.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nf = nf
        self.compute_dtype = compute_dtype
        self.conv_first_a = ConvPReLU(3, nf, stride=1)
        self.conv_first_b = ConvPReLU(nf, nf, stride=2)
        self.feature_extraction = ResBlocks(nf, enc_res_blocks)
        self.l2a = ConvPReLU(nf, nf, stride=2)
        self.l2b = ConvPReLU(nf, nf)
        self.l3a = ConvPReLU(nf, nf, stride=2)
        self.l3b = ConvPReLU(nf, nf)
        self.dcn_builder = DCNInterFeatBuilder(nf)
        self.query_builder2 = conv_transpose_x2(nf, nf)
        self.decoder2 = SwinDecoder(nf, depth=8, num_heads=8, window_size=4,
                                    mlp_ratio=mlp_ratio)
        self.query_builder1 = conv_transpose_x2(nf, nf)
        self.decoder1 = SwinDecoder(nf, depth=8, num_heads=4, window_size=4,
                                    mlp_ratio=mlp_ratio)
        # The generator's layers, which flax names at the model's top level.
        self.reconstruction = ResBlocks(nf, dec_res_blocks)
        self.upconv1 = conv(nf, nf * 4)
        self.prelu1 = PReLU(nf)
        self.hrconv = conv(nf, nf)
        self.prelu2 = PReLU(nf)
        self.conv_last = conv(nf, 3)

    def _rgb(self, feat: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        """``clamp(rgb + mean, 0, 1)`` in fp32. JAX adds the mean (rounded
        to the compute dtype) in the compute dtype and casts the sum to
        fp32; XLA drops that rounding, so the sum is taken in fp32 here
        (DAT's generator rounds it)."""
        h = self.upconv1(self.reconstruction(feat))
        h = self.prelu2(self.hrconv(self.prelu1(pixel_shuffle(h, 2))))
        h = self.conv_last(h).float() + mean.to(h.dtype).float()
        return torch.minimum(torch.maximum(h, h.new_zeros(())), h.new_ones(()))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be wider: fp32 master weights)."""
        return self.compute_dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The encoder pyramid (1/2, 1/4, 1/8) of mean-normalised frames
        (the geometry loss encodes the ground truth with it), in the
        compute dtype."""
        f1 = self.feature_extraction(self.conv_first_b(self.conv_first_a(x.to(self.dtype))))
        f2 = self.l2b(self.l2a(f1))
        return f1, f2, self.l3b(self.l3a(f2))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                train: bool = False):
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 16 (``t``
        is not read); returns the ``(B, H, W, 3)`` fp32 frame and, with
        ``train``, JAX's intermediates."""
        B = x0.shape[0]
        mean = 0.5 * (x0.mean(dim=(1, 2), keepdim=True) + x1.mean(dim=(1, 2), keepdim=True))
        feats = self.encode(torch.cat([x0 - mean, x1 - mean], dim=0))
        f0 = [f[:B] for f in feats]
        f1 = [f[B:] for f in feats]

        feat_t_3, f01, f10 = self.dcn_builder(f0[2], f1[2])
        feat_t_2q = self.query_builder2(feat_t_3)
        _, h, w, _ = feat_t_2q.shape
        pos = position_embedding_sine(h, w, self.nf // 2, dtype=feat_t_2q.dtype,
                                      device=feat_t_2q.device)
        feat_t_2 = self.decoder2(feat_t_2q + pos, f0[1] + pos, f1[1] + pos)
        feat_t_1 = self.decoder1(self.query_builder1(feat_t_2), f0[0], f1[0])
        pred = self._rgb(feat_t_1, mean)
        if not train:
            return pred
        return pred, {"feat_t_3": feat_t_3, "feat_t_2": feat_t_2q, "f01_off": f01.float(),
                      "f10_off": f10.float(), "mean": mean}


def dcntrans_loss(pred: torch.Tensor, intermediates: dict, batch: dict, gt_feats):
    """DCNTrans's training loss, ``(total, log)`` with JAX's log keys and
    order of terms: Charbonnier L1 and census on the frame; 0.01 times the
    geometry loss of ``feat_t_3`` and ``feat_t_2`` against levels 3 and 2
    of ``gt_feats`` (``model.encode(xt - mean)``); 0.01 times the
    robust-weighted (beta 0.3) Charbonnier of the offset flows, upsampled
    8x (``align_corners``) and magnified 8x, against the pseudo-GT flows
    ``f0x`` and ``f1x``, which the batch must carry."""
    xt = batch["xt"]
    l1 = charbonnier_l1(pred - xt)
    census = ternary_loss(pred, xt)
    geo = 0.01 * (geometry_loss(intermediates["feat_t_3"].float(), gt_feats[2].float())
                  + geometry_loss(intermediates["feat_t_2"].float(), gt_feats[1].float()))
    if "f0x" not in batch:
        # JAX's loss fails here with KeyError 'f0x'.
        raise ValueError("DCNTrans's flow distillation needs the batch's pseudo-GT flows f0x "
                         "and f1x: train on data_name Vimeo90KwFlow (configs/archive/"
                         "DCNTrans.yaml names Vimeo90K, whose batches carry none)")

    def up8(f):
        H, W = f.shape[1:3]
        return resize_bilinear(f, (H * 8, W * 8), align_corners=True) * 8.0

    p01, p10 = up8(intermediates["f01_off"]), up8(intermediates["f10_off"])
    w0 = get_robust_weight(p01, batch["f0x"], beta=0.3)
    w1 = get_robust_weight(p10, batch["f1x"], beta=0.3)
    distill = 0.01 * (charbonnier_ada(p01 - batch["f0x"], w0)
                      + charbonnier_ada(p10 - batch["f1x"], w1))
    total = l1 + census + geo + distill
    return total, {"total_loss": total, "l1_loss": l1, "census_loss": census,
                   "geometry_loss": geo, "flow_loss": distill}
