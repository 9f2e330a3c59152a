"""GMTrans (counterpart of ``videoframeinterpolation_tpu/models/gmtrans.py``).

  1/2, 1/4, 1/8  a conv pyramid (48 / 96 / 128 channels) on both frames,
       normalised by one scalar mean per image
  1/8  the sine position embedding per window, the feature transformer
       (:class:`..nn.transformer.FeatureTransformer`, six blocks), the
       global correlation softmax: both flows and the dual-softmax
       certainty, whose complement times ``alpha`` is the splat metric
       -> both frames' 1/8 features splatted to ``t``
       (:func:`..ops.fwarp_using_two_frames`)
  1/4  ConvTranspose -> Swin decoder (6 deep, 6 heads, window 4), with a
       ConvTranspose head to 48 channels at 1/2
  1/2  Swin decoder (6 deep, 6 heads, window 4) -> conv to 12, PixelShuffle
  1/1  the residual on both frames splatted to ``t`` along the flows
       upsampled 8x, plus the mean, clipped to [0, 1] in fp32

Module and parameter names are flax's (``enc1a``, ``transformer.layer3``,
``decoder3.transformer.block2.attn``, the root ``alpha``, ...). No
kernel of its own: the splats are :mod:`..ops.softsplat`'s
deterministic scatter, the attention cuBLAS products.

The encoder, the transformer and the correlation do not read ``t``:
:meth:`GMTrans.encode` runs them once per pair and :meth:`GMTrans.decode`
the splats and decoders per instant (``multi_t_apply``, ``--mode
direct``); ``forward`` is the two in turn. ``forward(..., train=True)``
also returns JAX's intermediates (``base``: the splatted frame plus the
mean, ``pred_f01``, ``pred_f10``: the flows at full resolution, all
fp32), and :func:`gmtrans_loss` is the training loss (JAX
``models/gmtrans.py:138-156``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import ConvPReLU, conv, conv_transpose_x2
from ..nn.swin import SwinDecoder
from ..nn.transformer import (FeatureTransformer, feature_add_position,
                              global_correlation_softmax)
from ..ops import (charbonnier_l1, fwarp_using_two_frames, pixel_shuffle, resize_bilinear,
                   ternary_loss)


def _up8(x: torch.Tensor) -> torch.Tensor:
    """``x (B, H, W, C)`` resized 8x, bilinear with ``align_corners``."""
    H, W = x.shape[1:3]
    return resize_bilinear(x, (H * 8, W * 8), align_corners=True)


class GMTrans(nn.Module):
    def __init__(self, nf: int = 128, pyramid: tuple = (48, 96, 128),
                 num_transformer_layers: int = 6, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c3 = pyramid
        self.nf = nf
        self.compute_dtype = compute_dtype
        self.enc1a = ConvPReLU(3, c1, stride=2)
        self.enc1b = ConvPReLU(c1, c1)
        self.enc2a = ConvPReLU(c1, c2, stride=2)
        self.enc2b = ConvPReLU(c2, c2)
        self.enc3a = ConvPReLU(c2, c3, stride=2)
        self.enc3b = ConvPReLU(c3, c3)
        self.transformer = FeatureTransformer(num_transformer_layers, nf)
        self.decoder4 = conv_transpose_x2(c3, c2)
        self.decoder3 = SwinDecoder(c2, depth=6, num_heads=6, window_size=4, mlp_ratio=2.0,
                                    upsample_to=c1)
        self.decoder2 = SwinDecoder(c1, depth=6, num_heads=6, window_size=4, mlp_ratio=4.0)
        self.decoder1 = conv(c1, 12)
        self.alpha = nn.Parameter(torch.full((1, 1, 1, 1), 10.0))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be wider: fp32 master weights)."""
        return self.compute_dtype

    def encode(self, x0: torch.Tensor, x1: torch.Tensor):
        """What no instant changes: ``(feats, mean)``, ``mean (B, 1, 1, 1)``
        the pair's mean, ``feats`` the normalised frames, both frames'
        pyramids, the 1/8 flows and metrics and the full-resolution ones."""
        B = x0.shape[0]
        mean = 0.5 * (x0.mean(dim=(1, 2, 3), keepdim=True) + x1.mean(dim=(1, 2, 3), keepdim=True))
        x0n, x1n = (x0 - mean).to(self.dtype), (x1 - mean).to(self.dtype)
        # Both frames' pyramids in one batch (frame 0's first).
        f1 = self.enc1b(self.enc1a(torch.cat([x0n, x1n], dim=0)))
        f2 = self.enc2b(self.enc2a(f1))
        f3 = self.enc3b(self.enc3a(f2))
        _, fh, fw, _ = f3.shape

        a0, a1 = feature_add_position(f3[:B], f3[B:], 2, self.nf)
        a0, a1 = self.transformer(a0, a1, num_splits=2)
        f01, f10, dual_prob = global_correlation_softmax(a0, a1)
        dual_prob = dual_prob.detach()
        alpha = self.alpha.to(f01.dtype)
        z0 = (1.0 - dual_prob.amax(dim=-1).reshape(B, fh, fw, 1)).to(f01.dtype) * alpha
        z1 = (1.0 - dual_prob.amax(dim=-2).reshape(B, fh, fw, 1)).to(f01.dtype) * alpha
        feats = {"x0n": x0n, "x1n": x1n, "f1": f1, "f2": f2, "f3": f3, "f01": f01, "f10": f10,
                 "z0": z0, "z1": z1, "pred_f01": _up8(f01) * 8.0, "pred_f10": _up8(f10) * 8.0,
                 "z0_full": _up8(z0), "z1_full": _up8(z1)}
        return feats, mean

    def decode(self, feats: dict, mean: torch.Tensor, t: torch.Tensor, train: bool = False):
        """The frame at ``t (B, 1, 1, 1)`` from :meth:`encode`'s output (and,
        with ``train``, JAX's intermediates)."""
        B = mean.shape[0]
        tt = t.to(self.dtype)
        f1, f2, f3 = feats["f1"], feats["f2"], feats["f3"]
        feat_t_4, _ = fwarp_using_two_frames(f3[:B], feats["f01"] * tt, tt, f3[B:],
                                             feats["f10"] * (1.0 - tt), 1.0 - tt,
                                             feats["z0"], feats["z1"])
        feat_t_3 = self.decoder4(feat_t_4)
        feat_t_2 = self.decoder3(feat_t_3, f2[:B], f2[B:])
        feat_t_1 = self.decoder2(feat_t_2, f1[:B], f1[B:])
        residual = pixel_shuffle(self.decoder1(feat_t_1), 2)
        pred_f01, pred_f10 = feats["pred_f01"], feats["pred_f10"]
        base, _ = fwarp_using_two_frames(feats["x0n"], pred_f01 * tt, tt, feats["x1n"],
                                         pred_f10 * (1.0 - tt), 1.0 - tt,
                                         feats["z0_full"], feats["z1_full"])
        # JAX adds the mean (rounded to the compute dtype) in the compute
        # dtype and casts the sum to fp32; XLA drops that last rounding.
        mean_c = mean.to(base.dtype).float()
        pred = (base + residual).float() + mean_c
        pred = torch.minimum(torch.maximum(pred, pred.new_zeros(())), pred.new_ones(()))
        if not train:
            return pred
        return pred, {"base": base.float() + mean_c, "pred_f01": pred_f01.float(),
                      "pred_f10": pred_f10.float()}

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                train: bool = False):
        """``x0, x1 (B, H, W, 3)`` in [0, 1] with H, W divisible by 16 (the
        1/8 features split into 2 x 2 windows), ``t (B, 1, 1, 1)``; returns
        the ``(B, H, W, 3)`` fp32 frame and, with ``train``, JAX's
        intermediates."""
        feats, mean = self.encode(x0, x1)
        return self.decode(feats, mean, t, train=train)


def gmtrans_loss(pred: torch.Tensor, intermediates: dict, batch: dict):
    """GMTrans's training loss, ``(total, log)`` with JAX's log keys and
    order of terms: Charbonnier L1 and census on the frame and on the
    splatted base (clipped to [0, 1]); 0.01 times the mean squared error of
    the full-resolution flows against the pseudo-GT flows ``f0x`` and
    ``f1x``, which the batch must carry."""
    xt = batch["xt"]
    base = torch.minimum(torch.maximum(intermediates["base"], xt.new_zeros(())),
                         xt.new_ones(()))
    l1 = charbonnier_l1(pred - xt) + charbonnier_l1(base - xt)
    census = ternary_loss(pred, xt) + ternary_loss(base, xt)
    if "f0x" not in batch:
        # JAX's loss fails here with KeyError 'f0x'.
        raise ValueError("GMTrans's flow distillation needs the batch's pseudo-GT flows f0x "
                         "and f1x: train on data_name Vimeo90KwFlow (configs/archive/"
                         "GMTrans.yaml names Vimeo90K, whose batches carry none)")
    distill = 0.01 * (torch.mean((intermediates["pred_f01"] - batch["f0x"]) ** 2)
                      + torch.mean((intermediates["pred_f10"] - batch["f1x"]) ** 2))
    total = l1 + census + distill
    return total, {"total_loss": total, "l1_loss": l1, "census_loss": census,
                   "flow_loss": distill}
