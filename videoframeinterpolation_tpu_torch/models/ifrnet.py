"""IFRNet (counterpart of ``videoframeinterpolation_tpu/models/ifrnet.py``).

Coarse-to-fine flow and residual decoding: a growing-channel pyramid
encoder runs on each frame; four decoders predict the bidirectional flows
t->0 and t->1 (each level's the residual on the 2x upsampled, 2x magnified
flow of the level below) and the intermediate feature; the finest also
predicts a blend mask and a residual, merged as ``mask * warp(x0) + (1 -
mask) * warp(x1) + mean + residual``. :func:`ifrnet_loss` is its training
loss: Charbonnier, census, the geometry loss of the intermediate features
against the encoded ground truth, and the robust-weighted distillation of
the flows against pseudo-GT flows.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import ConvPReLU, HalfChannelConv5ResBlock, IFRNetEncoder, conv_transpose_x2, sigmoid
from ..ops import (bwarp, charbonnier_ada, charbonnier_l1, geometry_loss, get_robust_weight,
                   resize_bilinear, ternary_loss)
from .base import norm_w_rgb_mean


def _resize_flow(flow: torch.Tensor, scale: float) -> torch.Tensor:
    """IFRNet's resize: bilinear with ``align_corners=False`` to ``int(H *
    scale)`` by ``int(W * scale)``; the values are not rescaled."""
    B, H, W, C = flow.shape
    return resize_bilinear(flow, (int(H * scale), int(W * scale)), align_corners=False)


class _Decoder(nn.Module):
    """ConvPReLU, a side-channel residual block without its last
    activation, and a 2x transposed-conv upsample."""

    def __init__(self, in_features: int, mid_features: int, out_features: int,
                 side_features: int = 32):
        super().__init__()
        self.conv_in = ConvPReLU(in_features, mid_features)
        self.resblock = HalfChannelConv5ResBlock(
            mid_features, min(side_features, mid_features // 2), final_activation=False)
        self.up = conv_transpose_x2(mid_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(self.resblock(self.conv_in(x)))


class IFRNet(nn.Module):
    def __init__(self, channels: tuple = (32, 48, 72, 96),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c3, c4 = channels
        self.compute_dtype = compute_dtype
        self.encoder = IFRNetEncoder(channels)
        self.decoder4 = _Decoder(2 * c4 + 1, 2 * c4, 4 + c3)
        self.decoder3 = _Decoder(3 * c3 + 4, 3 * c3, 4 + c2)
        self.decoder2 = _Decoder(3 * c2 + 4, 3 * c2, 4 + c1)
        self.decoder1 = _Decoder(3 * c1 + 4, 3 * c1, 8)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be wider: fp32 master weights)."""
        return self.compute_dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The encoder pyramid of one mean-normalised frame (the geometry
        loss encodes the ground truth with it), in the compute dtype."""
        return self.encoder(x.to(self.dtype))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                train: bool = False):
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 16, ``t
        (B, 1, 1, 1)``; returns the ``(B, H, W, 3)`` fp32 frame at t and,
        with ``train``, the intermediates JAX returns: ``flows0`` and
        ``flows1`` (finest first), ``feats_t`` (levels 1-3), ``mask``,
        ``x0_warp``, ``x1_warp`` and ``mean`` (fp32)."""
        x0n, x1n, mean = norm_w_rgb_mean(x0, x1)
        f0_1, f0_2, f0_3, f0_4 = self.encode(x0n)
        f1_1, f1_2, f1_3, f1_4 = self.encode(x1n)
        x0n, x1n = x0n.to(self.dtype), x1n.to(self.dtype)

        B, h4, w4, _ = f0_4.shape
        embt = t.to(f0_4.dtype).expand(B, h4, w4, 1)
        out4 = self.decoder4(torch.cat([f0_4, f1_4, embt], dim=-1))
        flow0, flow1, ft = out4[..., 0:2], out4[..., 2:4], out4[..., 4:]
        flows0, flows1, feats_t = [flow0], [flow1], [ft]
        for decoder, fa, fb in ((self.decoder3, f0_3, f1_3), (self.decoder2, f0_2, f1_2),
                                (self.decoder1, f0_1, f1_1)):
            out = decoder(torch.cat([ft, bwarp(fa, flow0), bwarp(fb, flow1), flow0, flow1],
                                    dim=-1))
            flow0 = out[..., 0:2] + 2.0 * _resize_flow(flow0, 2.0)
            flow1 = out[..., 2:4] + 2.0 * _resize_flow(flow1, 2.0)
            ft = out[..., 4:]
            flows0.insert(0, flow0)
            flows1.insert(0, flow1)
            feats_t.insert(0, ft)
        mask = sigmoid(ft[..., 0:1])
        res = ft[..., 1:]

        x0_warp = bwarp(x0n, flow0)
        x1_warp = bwarp(x1n, flow1)
        merged = mask * x0_warp + (1.0 - mask) * x1_warp + mean.to(x0_warp.dtype)
        # JAX rounds ``merged + res`` to the compute dtype and casts it to
        # fp32; XLA drops that rounding (it allows excess precision), so the
        # last sum is taken in fp32, as here.
        img = merged.float() + res.float()
        img_pred = torch.minimum(torch.maximum(img, img.new_zeros(())), img.new_ones(()))
        if not train:
            return img_pred
        return img_pred, {"flows0": flows0, "flows1": flows1, "feats_t": feats_t[1:],
                          "mask": mask, "x0_warp": x0_warp, "x1_warp": x1_warp, "mean": mean}


def ifrnet_loss(img_pred: torch.Tensor, intermediates: dict, batch: dict, gt_feats,
                geo_lambda: float = 0.01, distill_lambda: float = 0.01):
    """IFRNet's training loss, ``(total, log)`` with JAX's log keys.

    Args:
      gt_feats: the encoder pyramid of the mean-normalised ground truth,
        ``model.encode(xt - mean)``.
    """
    xt = batch["xt"]
    f01, f10 = batch["f0x"], batch["f1x"]
    l1 = charbonnier_l1(img_pred - xt)
    census = ternary_loss(img_pred, xt)
    geo = geo_lambda * sum(geometry_loss(ft.float(), gt.float())
                           for ft, gt in zip(intermediates["feats_t"], gt_feats[:3]))
    flows0 = [f.float() for f in intermediates["flows0"]]
    flows1 = [f.float() for f in intermediates["flows1"]]
    w0 = get_robust_weight(flows0[0], f01, beta=0.3)
    w1 = get_robust_weight(flows1[0], f10, beta=0.3)
    distill = distill_lambda * (
        charbonnier_ada(2.0 * _resize_flow(flows0[1], 2.0) - f01, w0)
        + charbonnier_ada(2.0 * _resize_flow(flows1[1], 2.0) - f10, w1)
        + charbonnier_ada(4.0 * _resize_flow(flows0[2], 4.0) - f01, w0)
        + charbonnier_ada(4.0 * _resize_flow(flows1[2], 4.0) - f10, w1)
        + charbonnier_ada(8.0 * _resize_flow(flows0[3], 8.0) - f01, w0)
        + charbonnier_ada(8.0 * _resize_flow(flows1[3], 8.0) - f10, w1))
    total = l1 + census + geo + distill
    return total, {"total_loss": total, "l1_loss": l1, "census_loss": census,
                   "flow_loss": distill, "geometry_loss": geo}
