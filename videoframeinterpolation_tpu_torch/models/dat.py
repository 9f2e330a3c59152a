"""Flagship model (counterpart of ``videoframeinterpolation_tpu/models/dat.py:DATwConstantnC``).

  1/16  shared 4-level encoder on both frames (constant ``nf`` channels)
        -> t-conditioned DCN query builder gives (feat_t, ft0, ft1)
  1/8   ConvTranspose joint upsample of [feat || ft0 || ft1]
        -> deformable attention level 3 (nG=4, nH=4, scale 2)
  1/4   -> deformable attention level 2 (nG=8, nH=8, scale 4)
  1/2   -> deformable attention level 1 (nG=8, nH=8, scale 8, no flow)
  1/1   PixelShuffle generator -> clamp(rgb + mean, 0, 1)

``forward(..., train=True)`` also returns the flow pyramids the training
loss reads, and :func:`dat_loss` is that loss (JAX ``models/dat.py:207-236``).
:class:`CoarseToFineDAT` is the skeleton the flagship shares with DAT-TPU
(``models/dat_tpu.py``), which replaces the deformable attention levels.
The model computes in ``compute_dtype`` whatever the dtype of its
parameters: fp32 master parameters when it trains, parameters cast once
to the compute dtype when it serves.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import (
    charbonnier_ada,
    charbonnier_l1,
    get_robust_weight,
    scale_resize,
    ternary_loss,
)
from ..nn import (
    BasicResPixelShuffleGenerator,
    CrossDeformableAttentionBlock,
    DCNInterFeatBuilderWithT,
    SameChannelResEncoder,
    conv_transpose_x2,
)
from .base import norm_w_rgb_mean


class CoarseToFineDAT(nn.Module):
    """The DAT family's skeleton: the encoder, the query builder, the
    transposed-conv upsamplers between the levels and the generator. A
    subclass adds the three cross-attention levels ``dat_lv3``, ``dat_lv2``
    and ``dat_lv1``, each taking ``(feat_t, feat0, feat1, ft0, ft1)``; the
    first two also return the next level's flows."""

    def __init__(self, nf: int, enc_res_blocks: int, dec_res_blocks: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.nf = nf
        self.compute_dtype = compute_dtype
        self.feature_encoder = SameChannelResEncoder(nf, enc_res_blocks)
        self.coarse_query_builder = DCNInterFeatBuilderWithT(nf)
        self.lv4_to_lv3 = conv_transpose_x2(nf + 4, nf + 4)
        self.lv3_to_lv2 = conv_transpose_x2(nf, nf)
        self.lv2_to_lv1 = conv_transpose_x2(nf, nf)
        self.pixel_generator = BasicResPixelShuffleGenerator(nf, dec_res_blocks)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be wider: fp32 master weights)."""
        return self.compute_dtype

    def encode(self, x0: torch.Tensor, x1: torch.Tensor):
        """The t-invariant stage: normalization (in the input's dtype) and the
        shared-weight feature pyramid on both frames batched together (2B),
        in the compute dtype; ``mean`` keeps the input's dtype."""
        x0n, x1n, mean = norm_w_rgb_mean(x0, x1)
        x0n, x1n = x0n.to(self.dtype), x1n.to(self.dtype)
        feats = self.feature_encoder(torch.cat([x0n, x1n], dim=0))
        return feats, mean

    def decode(self, feats, mean: torch.Tensor, t: torch.Tensor, train: bool = False):
        """The t-dependent stage: query building, the cross-attention
        pyramid and the pixel generator. With ``train`` it
        returns ``(frame, intermediates)``: ``pred_ft0`` and ``pred_ft1``,
        each level's flows resized to full resolution (x2, x4, x8, x16 for
        levels 1-4), their magnitudes left in the level's pixel units."""
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
        img_pred = self.pixel_generator(attended_1, mean).float()
        if not train:
            return img_pred
        levels = ((ft0_1, ft1_1, 2.0), (ft0_2, ft1_2, 4.0), (ft0_3, ft1_3, 8.0),
                  (ft0_4, ft1_4, 16.0))
        return img_pred, {"pred_ft0": [scale_resize(f0, s) for f0, _, s in levels],
                          "pred_ft1": [scale_resize(f1, s) for _, f1, s in levels]}

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                train: bool = False):
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 16,
        ``t (B, 1, 1, 1)``; returns the ``(B, H, W, 3)`` fp32 frame at t
        and, with ``train``, the flow pyramids of :meth:`decode`."""
        feats, mean = self.encode(x0, x1)
        return self.decode(feats, mean, t, train=train)


class DATwConstantnC(CoarseToFineDAT):
    """The flagship with the JAX model's options: ``shared_offsets`` (one
    bool, or one per level lv3, lv2, lv1), ``n_samples``, ``attn_strides``
    (only lv1 may be 2), ``movement_nf`` (per level, None for ``nf``),
    ``ref_offset_units`` and ``window_sampling`` (each block's, see
    :class:`..nn.CrossDeformableAttentionBlock`)."""

    def __init__(self, nf: int = 72, enc_res_blocks: int = 5, dec_res_blocks: int = 10,
                 mlp_ratio: float = 2.0, window_sampling: bool = False,
                 shared_offsets: bool | tuple = False, n_samples: tuple = (8, 16, 32),
                 attn_strides: tuple = (1, 1, 1), movement_nf: tuple | None = None,
                 ref_offset_units: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__(nf, enc_res_blocks, dec_res_blocks, compute_dtype)
        so = shared_offsets
        so3, so2, so1 = (so, so, so) if isinstance(so, bool) else tuple(so)
        ns3, ns2, ns1 = n_samples
        st3, st2, st1 = attn_strides
        mv3, mv2, mv1 = movement_nf or (None, None, None)
        if st3 != 1 or st2 != 1:
            raise ValueError("attn_strides: only the finest level (lv1) may be strided; "
                             "lv3 and lv2 predict the next level's flows (pred_res_flow)")
        common = dict(mlp_ratio=mlp_ratio, window_sampling=window_sampling,
                      ref_offset_units=ref_offset_units)
        self.dat_lv3 = CrossDeformableAttentionBlock(
            nf, nf, n_samples=ns3, n_groups=4, n_heads=4, offset_scale=2.0,
            shared_offsets=so3, attn_stride=st3, movement_nf=mv3, **common)
        self.dat_lv2 = CrossDeformableAttentionBlock(
            nf, nf, n_samples=ns2, n_groups=8, n_heads=8, offset_scale=4.0,
            shared_offsets=so2, attn_stride=st2, movement_nf=mv2, **common)
        self.dat_lv1 = CrossDeformableAttentionBlock(
            nf, nf, n_samples=ns1, n_groups=8, n_heads=8, offset_scale=8.0,
            pred_res_flow=False, shared_offsets=so1, attn_stride=st1,
            movement_nf=mv1, **common)


def dat_loss(img_pred: torch.Tensor, intermediates: dict, batch: dict,
             distill_lambda: float | None = 0.01):
    """The flagship's training loss: Charbonnier L1 and the census loss on
    the frame, plus, where the batch has pseudo-GT flows (``f0x``, ``f1x``),
    ``distill_lambda`` times the robust-weighted Charbonnier of levels 2-4's
    flows against them, the weights taken from level 1's (detached) flow.
    Returns ``(total, log)`` with JAX's log keys."""
    xt = batch["xt"]
    l1 = charbonnier_l1(img_pred - xt)
    census = ternary_loss(img_pred, xt)
    total = l1 + census
    log = {"l1_loss": l1, "census_loss": census}
    if distill_lambda is not None and "f0x" in batch:
        ft0, ft1 = batch["f0x"], batch["f1x"]
        p0 = [f.float() for f in intermediates["pred_ft0"]]
        p1 = [f.float() for f in intermediates["pred_ft1"]]
        w0 = get_robust_weight(p0[0], ft0, beta=0.3)
        w1 = get_robust_weight(p1[0], ft1, beta=0.3)
        distill = (
            charbonnier_ada(p0[1] - ft0, w0) + charbonnier_ada(p1[1] - ft1, w1)
            + charbonnier_ada(p0[2] - ft0, w0) + charbonnier_ada(p1[2] - ft1, w1)
            + charbonnier_ada(p0[3] - ft0, w0) + charbonnier_ada(p1[3] - ft1, w1)
        )
        distill = distill_lambda * distill
        total = total + distill
        log["flow_loss"] = distill
    log["total_loss"] = total
    return total, log
