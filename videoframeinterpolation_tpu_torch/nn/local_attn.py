"""Flow-aligned local-window cross-attention (counterpart of ``videoframeinterpolation_tpu/nn/local_attn.py``).

DAT-TPU's attention block. Each source frame is warped once by the current
flow (``bwarp``); each query of the intermediate frame then attends over a
dense window of the warped features of both frames, ``2 * K^2`` positions
shifted by static offsets. The window is never materialised: keys and
values are projected once and shifted views of the projected maps are
taken, padded with the projection's bias (the projection of a zero
input), so the scores are those of attention over the zero-padded window.

Written as JAX writes it, one score product and one weighted add per tap
and frame, frame 0's taps first: the scores are products in the compute
dtype summed in fp32, the softmax over the taps runs in fp32, and the
weighted sum accumulates in fp32 in the taps' order. On the card these
are plain PyTorch operations, six small launches per tap and frame (a
shifted view plus the bias, a product and a sum for the score; the same
view, a product and an add for the value).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bwarp, scale_resize
from .blocks import (ConvPReLU, Dense, FeedForward, HalfChannelConv5ResBlock, conv,
                     conv_transpose_x2, zero_init)


def extract_local_windows(x: torch.Tensor, radius: int) -> torch.Tensor:
    """``(B, H, W, C) -> (B, K*K, H*W, C)``: the ``K = 2 * radius + 1``
    window of every pixel, zero padded, taps in row-major order."""
    B, H, W, C = x.shape
    K = 2 * radius + 1
    xp = F.pad(x, (0, 0, radius, radius, radius, radius))
    views = [xp[:, dy:dy + H, dx:dx + W] for dy in range(K) for dx in range(K)]
    return torch.stack(views, dim=1).reshape(B, K * K, H * W, C)


def _shifted(x: torch.Tensor, pad_val: torch.Tensor, shifts):
    """``_shift2d(x, dy, dx, pad_val)`` for each ``(dy, dx)`` of ``shifts``,
    in order, with the subtraction and the zero padding done once for all
    of them (the same values: a wider zero border changes no window)."""
    B, H, W, C = x.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in shifts)
    xs = F.pad(x - pad_val, (0, 0, r, r, r, r))
    for dy, dx in shifts:
        yield xs[:, r + dy:r + dy + H, r + dx:r + dx + W] + pad_val


def _shift2d(x: torch.Tensor, dy: int, dx: int, pad_val: torch.Tensor) -> torch.Tensor:
    """``x (B, H, W, C)`` read at ``(y + dy, x + dx)``, the exposed border
    filled with ``pad_val (C,)``: as JAX computes it, ``pad_val`` is
    subtracted, the map shifted with zero padding, and ``pad_val`` added
    back (in ``x``'s dtype, so the round trip rounds as JAX's does)."""
    return next(_shifted(x, pad_val, [(dy, dx)]))


class ShiftWindowSampleAttention(nn.Module):
    """Per-pixel attention over the ``2 * K^2`` shifted positions of both
    warped frames: head width ``hc = out_features / n_heads``, scale
    ``hc ** -0.5``. Taps are the cross product of ``offsets_1d`` with
    itself (dilated windows), or of ``[-radius, radius]``. Its parameters
    (``q_proj``, ``k_proj``, ``v_proj``) are ``SampleAttention``'s."""

    def __init__(self, features: int, out_features: int, radius: int, n_heads: int,
                 offsets_1d: tuple | None = None):
        super().__init__()
        self.out_features, self.n_heads = out_features, n_heads
        axis = (tuple(offsets_1d) if offsets_1d is not None
                else tuple(range(-radius, radius + 1)))
        self.shifts = [(dy, dx) for dy in axis for dx in axis]
        self.q_proj = Dense(features, out_features)
        self.k_proj = Dense(features, out_features)
        self.v_proj = Dense(features, out_features)

    def forward(self, q: torch.Tensor, warped0: torch.Tensor,
                warped1: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = q.shape
        nh = self.n_heads
        hc = self.out_features // nh
        qp = self.q_proj(q).reshape(B, H, W, nh, hc).float()
        both = torch.cat([warped0, warped1], dim=0)
        kp_b, vp_b = self.k_proj(both), self.v_proj(both)
        k_bias = self.k_proj.bias.to(kp_b.dtype)
        v_bias = self.v_proj.bias.to(vp_b.dtype)

        # Products of the compute dtype's keys and values with fp32 factors
        # promote to fp32, exactly: the values JAX's fp32 contractions see.
        scores = [(qp * ks.reshape(B, H, W, nh, hc)).sum(dim=-1)
                  for frame in (0, 1)
                  for ks in _shifted(kp_b[frame * B:(frame + 1) * B], k_bias, self.shifts)]
        attn = torch.softmax(torch.stack(scores, dim=-1) * hc ** -0.5, dim=-1)

        out = torch.zeros((B, H, W, nh, hc), dtype=torch.float32, device=q.device)
        taps = (vs for frame in (0, 1)
                for vs in _shifted(vp_b[frame * B:(frame + 1) * B], v_bias, self.shifts))
        for i, vs in enumerate(taps):
            out = out + attn[..., i, None] * vs.reshape(B, H, W, nh, hc)
        return out.reshape(B, H, W, self.out_features).to(q.dtype)


class LocalWindowCrossAttentionBlock(nn.Module):
    """DAT-TPU's counterpart of ``CrossDeformableAttentionBlock``, with the
    same ``(feat_t, feat0, feat1, ft0, ft1)`` interface and flow head: both
    frames (batched as 2B) are warped by their flows, the movement
    features are computed from ``[feat_t, warped, flow]``, and the query
    attends over the shifted windows of the warped frames. With
    ``n_offset_groups`` G > 0, each of G channel groups is warped again by
    the flow plus its own ``offset_scale * tanh`` offset, predicted by the
    zero-initialised ``conv_group_offset`` (at its initial values the block
    equals the block without offsets)."""

    def __init__(self, features: int, out_features: int, radius: int = 3, n_heads: int = 8,
                 mlp_ratio: float = 2.0, pred_res_flow: bool = True,
                 offsets_1d: tuple | None = None, n_offset_groups: int = 0,
                 offset_scale: float = 8.0):
        super().__init__()
        c = features
        self.pred_res_flow = pred_res_flow
        self.n_offset_groups = n_offset_groups
        self.offset_scale = offset_scale
        self.movement_conv1 = ConvPReLU(2 * c + 2, 2 * c)
        self.movement_conv2 = ConvPReLU(2 * c, c)
        self.movement_res = HalfChannelConv5ResBlock(c, c // 2)
        if n_offset_groups:
            self.conv_group_offset = conv(c, 2 * n_offset_groups, kernel_init=zero_init)
        if pred_res_flow:
            self.conv_res_flow = conv_transpose_x2(c, 2)
        self.attn = ShiftWindowSampleAttention(c, out_features, radius, n_heads,
                                               offsets_1d=offsets_1d)
        self.mlp = FeedForward(out_features, int(out_features * mlp_ratio), out_features)
        # Without group offsets and the flow head (DAT-TPU's level 1) the
        # movement features feed nothing: JAX computes them and XLA drops the
        # dead code. The port skips them; their parameters stay in the tree
        # and take no gradient (zero, as jax.grad gives them; AdamW still
        # decays them), so data parallelism sees no unused parameter.
        self.uses_movement = bool(n_offset_groups) or pred_res_flow
        if not self.uses_movement:
            for m in (self.movement_conv1, self.movement_conv2, self.movement_res):
                m.requires_grad_(False)

    def forward(self, feat_t, feat0, feat1, ft0, ft1):
        B = feat_t.shape[0]
        feat_b = torch.cat([feat0, feat1], dim=0)
        ft_b = torch.cat([ft0, ft1], dim=0)
        feat_t_b = torch.cat([feat_t, feat_t], dim=0)

        warped_b = bwarp(feat_b, ft_b)
        if self.uses_movement:
            h = torch.cat([feat_t_b, warped_b, ft_b], dim=-1)
            mv_b = self.movement_res(self.movement_conv2(self.movement_conv1(h)))

        if self.n_offset_groups:
            G = self.n_offset_groups
            B2, H, W, C = feat_b.shape
            Cg = C // G
            off = self.offset_scale * torch.tanh(self.conv_group_offset(mv_b))
            flows_g = (ft_b[:, :, :, None, :] + off.reshape(B2, H, W, G, 2)).permute(0, 3, 1, 2, 4)
            feat_g = feat_b.reshape(B2, H, W, G, Cg).permute(0, 3, 1, 2, 4)
            warped_g = bwarp(feat_g.reshape(B2 * G, H, W, Cg), flows_g.reshape(B2 * G, H, W, 2))
            warped_b = warped_g.reshape(B2, G, H, W, Cg).permute(0, 2, 3, 1, 4).reshape(
                B2, H, W, C)

        attended = self.attn(feat_t, warped_b[:B], warped_b[B:])
        out = attended + self.mlp(attended)
        if not self.pred_res_flow:
            return out
        up_b = self.conv_res_flow(mv_b) + 2.0 * scale_resize(ft_b, 2.0)
        return out, up_b[:B], up_b[B:]
