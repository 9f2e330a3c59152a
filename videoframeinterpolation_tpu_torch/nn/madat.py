"""Motion-aware deformable attention modules (counterpart of ``videoframeinterpolation_tpu/nn/madat.py``).

EMA-VFI-style motion estimated from attention scores through coordinate
embeddings:

  * :class:`InterFrameAttention`: full cross-frame attention at 1/8, both
    directions folded into the batch axis, whose probabilities also carry
    a coordinate embedding: motion = proj(attn @ cor_embed - cor_embed);
  * :class:`FlowSelfAttnPropagation`: one self-attention over every token
    of a level that propagates a value and both flows;
  * :class:`DATWithMotionEstimation`: LayerNorm-ed deformable attention
    over both source frames (the hand-written sampler,
    :func:`..kernels.window_sample.deformable_sample`, one launch per level
    for both frames on 2B) whose per-frame sample scores turn the sampled
    coordinates into a motion feature.

The products are plain ``torch.matmul``/``einsum`` calls (cuBLAS on the
card; no Pallas kernel computes them in the JAX package). As in JAX every
contraction takes its operands in the compute dtype and sums in fp32
(products of bf16 values are exact in fp32), the softmaxes run in fp32
and their probabilities are rounded to the compute dtype. Module and
parameter names are flax's (``norm1``, ``kv_proj``, ``mlp.dwconv``,
``res.conv2``, ``conv_res_offset``, ...), and each layer is initialised
by the rule its flax counterpart names: flax's default ``lecun_normal``
for ``nn.Dense`` and the depthwise ``nn.Conv``, xavier-uniform in
:class:`FlowSelfAttnPropagation`, zeros for ``conv_res_offset``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.window_sample import deformable_sample
from ..ops import bwarp
from ..ops.warp import base_grid
from .blocks import (ConvPReLU, Conv2d, Dense, LayerNorm, PReLU, conv, gelu, lecun_normal_init,
                     zero_init)
from .swin import _on_device
from .transformer import _inv_sqrt, xavier_uniform


def _linspace(n: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, n)`` in fp32 as XLA computes it inside a
    jitted program: ``step = i * (1 / (n - 1))`` (the division by a
    constant becomes a product with its fp32 reciprocal), then ``-1 * (1 -
    step) + 1 * step``, each step rounded to fp32, and the last point
    ``1``. (``torch.linspace`` and a float64 evaluation rounded once give
    other bits at most sizes.)"""
    if n == 1:
        return np.full(1, -1.0, np.float32)
    step = np.arange(n - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(n - 1))
    out = np.float32(-1.0) * (np.float32(1.0) - step) + np.float32(1.0) * step
    return np.append(out, np.float32(1.0)).astype(np.float32)


def _normalized_grid(h: int, w: int) -> np.ndarray:
    """The fp32 ``[-1, 1]`` grid ``(1, h*w, 2)`` as ``(x, y)``."""
    gy, gx = np.meshgrid(_linspace(h), _linspace(w), indexing="ij")
    return np.stack([gx, gy], -1).reshape(1, h * w, 2)


def normalized_coords(h: int, w: int, dtype: torch.dtype = torch.float32,
                      device=None) -> torch.Tensor:
    """The ``[-1, 1]`` coordinate grid ``(1, h*w, 2)`` as ``(x, y)``: JAX's
    ``_normalized_coords`` bit for bit (its fp32 values, rounded once to
    ``dtype``), made once per size and device."""
    return _on_device(_normalized_grid, (h, w), torch.device(device or "cpu")).to(dtype)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of compute-dtype operands summed in fp32 (JAX's
    ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(a.float(), b.float())


class DWConvMlp(nn.Module):
    """Dense, depthwise 3x3 conv, exact GELU, Dense on ``(B, N, C)`` tokens
    of an ``h x w`` map. The flax depthwise kernel ``(3, 3, 1, hidden)`` is
    a ``groups=hidden`` conv here."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.hidden = hidden
        self.fc1 = Dense(in_features, hidden, kernel_init=lecun_normal_init)
        self.dwconv = Conv2d(hidden, hidden, 3, 1, 1, groups=hidden,
                             kernel_init=lecun_normal_init)
        self.fc2 = Dense(hidden, out, kernel_init=lecun_normal_init)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        B, N, _ = x.shape
        xs = self.dwconv(self.fc1(x).reshape(B, h, w, self.hidden))
        return self.fc2(gelu(xs.reshape(B, N, self.hidden)))


def _lecun_dense(i: int, o: int) -> Dense:
    return Dense(i, o, kernel_init=lecun_normal_init)


class InterFrameAttention(nn.Module):
    """Bidirectional cross-frame attention at 1/8: ``(out, motion)``, both
    ``(2B, H, W, .)`` with frame 0's direction first. One ``norm1`` serves
    both frames; the coordinate embedding is a Dense of the normalised grid
    in the compute dtype, and ``motion_proj`` reads ``attn @ cor_embed``
    rounded to the compute dtype minus the embedding."""

    def __init__(self, dim: int, motion_dim: int = 64, num_heads: int = 8,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.dim, self.motion_dim, self.num_heads = dim, motion_dim, num_heads
        self.norm1 = LayerNorm(dim)
        self.q_proj = _lecun_dense(dim, dim)
        self.kv_proj = _lecun_dense(dim, 2 * dim)
        self.cor_embed = _lecun_dense(2, motion_dim)
        self.proj = _lecun_dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = DWConvMlp(dim, int(dim * mlp_ratio), dim)
        self.motion_proj = _lecun_dense(motion_dim, motion_dim)

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor):
        B0, H, W, C = feat0.shape
        nh, N = self.num_heads, H * W
        hc, mc = C // nh, self.motion_dim // nh
        dtype = feat0.dtype
        feat_s = self.norm1(torch.cat([feat0, feat1], dim=0).reshape(2 * B0, N, C))
        feat_t = torch.cat([feat_s[B0:], feat_s[:B0]], dim=0)
        B = 2 * B0
        cor = normalized_coords(H, W, dtype, feat_s.device).expand(B, N, 2)

        q = self.q_proj(feat_s)
        k, v = self.kv_proj(feat_t).split(C, dim=-1)
        cor_embed_flat = self.cor_embed(cor)

        def heads(x, c):
            return x.reshape(B, N, nh, c).transpose(1, 2)

        attn = _f32_matmul(heads(q, hc), heads(k, hc).transpose(-1, -2)) * hc ** -0.5
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        # One product for the values and the coordinate embedding (the
        # same probabilities, each column summed alone).
        moved = _f32_matmul(attn, torch.cat([heads(v, hc), heads(cor_embed_flat, mc)], dim=-1))
        x = moved[..., :hc].transpose(1, 2).reshape(B, N, C).to(dtype)
        # XLA takes the residual sum in fp32 inside norm2, which reads it
        # in fp32: norm2 sees it unrounded, the residual rounded.
        sum32 = self.proj(x).float() + feat_s.float()
        feat_s = sum32.to(dtype)
        out = feat_s + self.mlp(self.norm2(sum32).to(dtype), H, W)

        c_rev = moved[..., hc:].transpose(1, 2).reshape(B, N, self.motion_dim)
        motion = self.motion_proj(c_rev.to(dtype) - cor_embed_flat)
        return out.reshape(B, H, W, C), motion.reshape(B, H, W, self.motion_dim)


class FlowSelfAttnPropagation(nn.Module):
    """A value and both flows propagated by one self-attention over every
    token of the level. JAX's quirks are kept: ``k_proj`` and ``v_proj``
    read the query projection, not the tokens; the kernels are
    xavier-uniform; one probability matrix in the compute dtype carries the
    value and both flows, each summed in fp32 and rounded to its own dtype.
    The scores are divided by ``sqrt(C)`` as XLA does it, a product with
    the fp32 reciprocal."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.q_proj = Dense(c, c, kernel_init=xavier_uniform)
        self.k_proj = Dense(c, c, kernel_init=xavier_uniform)
        self.v_proj = Dense(c, c, kernel_init=xavier_uniform)

    def forward(self, feat_t: torch.Tensor, flow0: torch.Tensor, flow1: torch.Tensor):
        B, H, W, C = feat_t.shape
        q = self.q_proj(feat_t.reshape(B, H * W, C))
        k = self.k_proj(q)
        scores = _f32_matmul(q, k.transpose(1, 2)).mul_(_inv_sqrt(C))
        prob = torch.softmax(scores, dim=-1).to(feat_t.dtype)
        del scores
        value = self.v_proj(q)
        vals = [value, flow0.reshape(B, H * W, -1), flow1.reshape(B, H * W, -1)]
        widths = [v.shape[-1] for v in vals]
        out = _f32_matmul(prob, torch.cat(vals, dim=-1)).split(widths, dim=-1)
        return tuple(o.reshape(B, H, W, -1).to(x.dtype)
                     for o, x in zip(out, (feat_t, flow0, flow1)))


class SmallResBlock(nn.Module):
    """Three convs with a side channel: ``conv1``, the last
    ``side_features`` channels refined by ``conv2``, ``conv3``, and the
    identity skip."""

    def __init__(self, features: int, side_features: int):
        super().__init__()
        c, s = features, side_features
        self.side = s
        self.conv1 = conv(c, c)
        self.prelu1 = PReLU(c)
        self.conv2 = conv(s, s)
        self.prelu2 = PReLU(s)
        self.conv3 = conv(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu1(self.conv1(x))
        s = out.shape[-1] - self.side
        out = torch.cat([out[..., :s], self.prelu2(self.conv2(out[..., s:]))], dim=-1)
        return x + self.conv3(out)


class DATWithMotionEstimation(nn.Module):
    """Deformable attention with motion from its sample scores (JAX
    ``DATWithMotionEstimation``). Needs ``n_groups == n_heads``, as JAX
    asserts.

    Per source frame (both on 2B): the movement features of ``[feat_t,
    bwarp(feat_x, ftx), ftx]``; ``conv_res_offset`` predicts the residual
    offsets ``offset_scale * tanh(.)``; the sampler takes ``norm1`` of the
    source features at ``q + ftx + res`` (one launch per level, ``ftx`` as
    its flow). The query attends over both frames' ``2 * n_samples``
    samples; separately, each frame's own S-wide softmax of the same fp32
    scores weights the projected, normalised sample coordinates
    (``coord_proj``), whose mean over the groups minus the projected grid
    gives that frame's motion (``motion_proj``).

    XLA takes the compute dtype's ``res + ftx`` in fp32 in both of its
    consumers (the sampler, and the coordinates of the motion), each of
    which casts it to fp32."""

    def __init__(self, features: int, out_features: int, n_samples: int = 9,
                 n_groups: int = 4, n_heads: int = 4, mlp_ratio: float = 2.0,
                 offset_scale: float = 2.0, motion_dim: int = 64):
        super().__init__()
        if n_groups != n_heads:
            raise ValueError(f"DATWithMotionEstimation needs n_groups == n_heads; got "
                             f"{n_groups} and {n_heads}")
        c = features
        self.n_samples, self.n_groups, self.n_heads = n_samples, n_groups, n_heads
        self.out_features, self.offset_scale = out_features, offset_scale
        self.motion_dim = motion_dim
        self.conv_in = ConvPReLU(2 * c + 2, c)
        self.res = SmallResBlock(c, c // 2)
        self.conv_res_offset = conv(c, n_groups * n_samples * 2, kernel_init=zero_init)
        self.norm1 = LayerNorm(c)
        self.norm2 = LayerNorm(out_features)
        self.q_proj = _lecun_dense(c, out_features)
        self.k_proj = _lecun_dense(c, out_features)
        self.v_proj = _lecun_dense(c, out_features)
        self.coord_proj = _lecun_dense(2, out_features)
        self.motion_proj = _lecun_dense(out_features, motion_dim)
        self.mlp = DWConvMlp(out_features, int(out_features * mlp_ratio), out_features)

    def _motion(self, ft_b: torch.Tensor, res_b: torch.Tensor, score_b: torch.Tensor):
        """Both frames' motion ``(2B, H, W, motion_dim)`` from their offsets
        (``ft_b`` plus ``res_b``) and their S-wide sample scores ``score_b
        (2B, S, N, G)`` in fp32."""
        B2, H, W, G, S, _ = res_b.shape
        N = H * W
        dtype = res_b.dtype
        coords = base_grid(H, W, ft_b.device)[None, :, :, None, None, :] + (
            res_b.float() + ft_b.float()[:, :, :, None, None, :])
        norm = torch.tensor([2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)], dtype=torch.float32,
                            device=ft_b.device)
        coords = coords * norm - 1.0
        proj = self.coord_proj(coords.to(dtype)).reshape(B2, N, G, S, -1)
        moved = torch.einsum("bsng,bngsc->bngc", score_b.to(dtype).float(), proj.float())
        moved = moved.to(dtype).float().mean(dim=2).to(dtype)
        base_proj = self.coord_proj(normalized_coords(H, W, dtype, ft_b.device))
        return self.motion_proj(moved - base_proj).reshape(B2, H, W, self.motion_dim)

    def forward(self, feat_t, feat0, feat1, ft0, ft1):
        """``feat_t (B, H, W, C)``, the source features ``feat0, feat1`` and
        the flows from t ``ft0, ft1 (B, H, W, 2)``; returns ``(feat,
        motion_t0, motion_t1)``."""
        B, H, W, C = feat_t.shape
        S, G, nh = self.n_samples, self.n_groups, self.n_heads
        hc, N = self.out_features // nh, H * W
        feat_b = torch.cat([feat0, feat1], dim=0)
        ft_b = torch.cat([ft0, ft1], dim=0)
        h = torch.cat([torch.cat([feat_t, feat_t], dim=0), bwarp(feat_b, ft_b), ft_b], dim=-1)
        mv_b = self.res(self.conv_in(h))
        res_b = self.offset_scale * torch.tanh(self.conv_res_offset(mv_b))
        res_b = res_b.reshape(2 * B, H, W, G, S, 2).contiguous()
        kv_b = deformable_sample(self.norm1(feat_b).contiguous(), ft_b.contiguous(), res_b, G)
        kv = torch.cat([kv_b[:B], kv_b[B:]], dim=1)               # (B, 2S, N, C)
        feat_tn = self.norm1(feat_t).reshape(B, N, C)

        q = self.q_proj(feat_tn).reshape(B, N, nh, hc)
        k = self.k_proj(kv).reshape(B, 2 * S, N, nh, hc)
        v = self.v_proj(kv).reshape(B, 2 * S, N, nh, hc)
        attn = torch.einsum("bnhc,bsnhc->bsnh", q.float(), k.float()) * hc ** -0.5
        score = torch.softmax(attn, dim=1).to(v.dtype)
        out = torch.einsum("bsnh,bsnhc->bnhc", score.float(), v.float())
        out = out.reshape(B, N, self.out_features).to(feat_t.dtype)

        # As in InterFrameAttention: norm2 reads the residual sum unrounded.
        sum32 = feat_tn.float() + out.float()
        feat = sum32.to(feat_t.dtype)
        feat = feat + self.mlp(self.norm2(sum32).to(feat.dtype), H, W)
        feat = feat.reshape(B, H, W, self.out_features)

        # Each frame's own softmax over its S samples, frame 0's first.
        score_b = torch.softmax(attn.reshape(B, 2, S, N, nh), dim=2)
        score_b = score_b.transpose(0, 1).reshape(2 * B, S, N, nh)
        motion_b = self._motion(ft_b, res_b, score_b)
        return feat, motion_b[:B], motion_b[B:]
