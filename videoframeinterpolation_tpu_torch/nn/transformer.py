"""GMFlow-style feature transformer and global correlation matching (counterpart of ``videoframeinterpolation_tpu/nn/transformer.py``).

Split-window single-head attention (odd layers on windows shifted by
half a window, with the Swin region mask), self- and cross-attention
blocks run for both directions at once (the two directions folded into
the batch axis), and the all-pairs correlation softmax that gives both
flows and the dual-softmax certainty.

The products are plain ``torch.matmul`` calls (cuBLAS on the card; no
Pallas kernel computes them in the JAX package). As in JAX, the scores
are summed in fp32 from operands in the compute dtype, scaled and
softmaxed in fp32; the probabilities are rounded to the compute dtype and
the attended values summed in fp32 and rounded once. XLA divides by
``sqrt(c)`` as a product with the fp32 reciprocal (:func:`_inv_sqrt`);
the port does the same, so that the bf16 probabilities round alike.
Module and parameter names are flax's (``layer0.self_attn.q_proj``,
``layer3.cross_attn_ffn.mlp2``, ...).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .blocks import Dense, LayerNorm, gelu
from .position import position_embedding_sine
from .swin import _on_device


def xavier_uniform(w: torch.Tensor, fan_in: int = 0) -> None:
    """flax's ``xavier_uniform()``: ``U(+-sqrt(6 / (fan_in + fan_out)))``."""
    nn.init.xavier_uniform_(w)


def _inv_sqrt(c: int) -> float:
    """``1 / sqrt(c)`` as XLA multiplies by it: the fp32 reciprocal of the
    fp32 ``sqrt(c)``."""
    return float(np.float32(1.0) / np.float32(c ** 0.5))


def split_windows(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """``(B, H, W, C) -> (B * K * K, H / K, W / K, C)``, windows row-major."""
    B, H, W, C = x.shape
    K = num_splits
    x = x.reshape(B, K, H // K, K, W // K, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B * K * K, H // K, W // K, C)


def merge_windows(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """The inverse of :func:`split_windows`."""
    BKK, h, w, C = x.shape
    K = num_splits
    x = x.reshape(BKK // (K * K), K, K, h, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(BKK // (K * K), K * h, K * w, C)


def shifted_window_attn_mask(h: int, w: int, num_splits: int) -> np.ndarray:
    """The shifted windows' additive mask ``(K * K, win, win)`` for an
    ``h x w`` map in ``K x K`` windows (``win`` tokens each): -100 between
    tokens of different regions of the rolled map, else 0, built on the
    host (:class:`FeatureTransformer` keeps it on the device per shape)."""
    wsh, wsw = h // num_splits, w // num_splits
    ssh, ssw = wsh // 2, wsw // 2
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -wsh), slice(-wsh, -ssh), slice(-ssh, None)):
        for ws in (slice(0, -wsw), slice(-wsw, -ssw), slice(-ssw, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(num_splits, wsh, num_splits, wsw).transpose(0, 2, 1, 3).reshape(-1, wsh * wsw)
    mask = m[:, None, :] - m[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Single-head attention of ``(N, L, C)`` queries onto ``(N, M, C)``
    keys and values; ``mask (nW, L, M)`` added to each run of ``nW``
    consecutive rows of the batch."""
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * _inv_sqrt(q.shape[-1])
    if mask is not None:
        nW = mask.shape[0]
        scores = (scores.reshape(-1, nW, *scores.shape[1:]) + mask).reshape(scores.shape)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-head attention over every token, ``(B, L, C)``."""
    return _attend(q, k, v)


def swin_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, w: int,
                          num_splits: int, with_shift: bool,
                          attn_mask: torch.Tensor | None) -> torch.Tensor:
    """Single-head attention within ``num_splits x num_splits`` windows of
    the ``h x w`` map, ``(B, L, C)``; with ``with_shift`` the maps are
    rolled by half a window first (and back after) and ``attn_mask``
    (:func:`shifted_window_attn_mask`) separates the regions."""
    B, L, C = q.shape
    wsh, wsw = h // num_splits, w // num_splits
    shift = (wsh // 2, wsw // 2)

    def windows(x):
        x = x.reshape(B, h, w, C)
        if with_shift:
            x = torch.roll(x, (-shift[0], -shift[1]), dims=(1, 2))
        return split_windows(x, num_splits).reshape(-1, wsh * wsw, C)

    out = _attend(windows(q), windows(k), windows(v), attn_mask if with_shift else None)
    out = merge_windows(out.reshape(-1, wsh, wsw, C), num_splits)
    if with_shift:
        out = torch.roll(out, shift, dims=(1, 2))
    return out.reshape(B, L, C)


class TransformerLayer(nn.Module):
    """Single-head attention of ``source`` onto ``target`` (``q_proj``,
    ``k_proj``, ``v_proj``, ``merge``: bias-free Dense, xavier-uniform),
    ``norm1``; then, unless ``no_ffn``, the concat FFN (``mlp1`` on
    ``[source || message]``, exact GELU, ``mlp2``) and ``norm2``; the
    message is added to ``source``."""

    def __init__(self, d_model: int, no_ffn: bool = False, ffn_dim_expansion: int = 4):
        super().__init__()
        self.no_ffn = no_ffn

        def dense(i, o):
            return Dense(i, o, bias=False, kernel_init=xavier_uniform)

        self.q_proj = dense(d_model, d_model)
        self.k_proj = dense(d_model, d_model)
        self.v_proj = dense(d_model, d_model)
        self.merge = dense(d_model, d_model)
        self.norm1 = LayerNorm(d_model)
        if not no_ffn:
            hidden = d_model * 2 * ffn_dim_expansion
            self.mlp1 = dense(2 * d_model, hidden)
            self.mlp2 = dense(hidden, d_model)
            self.norm2 = LayerNorm(d_model)

    def forward(self, source: torch.Tensor, target: torch.Tensor, *, h: int, w: int,
                num_splits: int, with_shift: bool,
                attn_mask: torch.Tensor | None) -> torch.Tensor:
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        if num_splits > 1:
            message = swin_window_attention(q, k, v, h, w, num_splits, with_shift, attn_mask)
        else:
            message = full_attention(q, k, v)
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            hidden = gelu(self.mlp1(torch.cat([source, message], dim=-1)))
            message = self.norm2(self.mlp2(hidden))
        return source + message


class TransformerBlock(nn.Module):
    """Self-attention (``self_attn``, no FFN), then cross-attention with the
    FFN (``cross_attn_ffn``)."""

    def __init__(self, d_model: int, ffn_dim_expansion: int = 4):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(d_model, ffn_dim_expansion=ffn_dim_expansion)

    def forward(self, source: torch.Tensor, target: torch.Tensor, **kw) -> torch.Tensor:
        return self.cross_attn_ffn(self.self_attn(source, source, **kw), target, **kw)


class FeatureTransformer(nn.Module):
    """``num_layers`` blocks (``layer0``, ...) over both frames' features:
    the two directions run as one batch (frame 0 attending onto frame 1,
    and frame 1 onto frame 0); odd layers use shifted windows."""

    def __init__(self, num_layers: int = 6, d_model: int = 128, ffn_dim_expansion: int = 4):
        super().__init__()
        self.num_layers, self.d_model = num_layers, d_model
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerBlock(d_model, ffn_dim_expansion))

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor,
                num_splits: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
        B, H, W, C = feature0.shape
        if C != self.d_model:
            raise ValueError(f"features of {C} channels into a transformer of {self.d_model}")
        mask = None
        if num_splits > 1:
            mask = _on_device(shifted_window_attn_mask, (H, W, num_splits), feature0.device)
        f0 = feature0.reshape(B, H * W, C)
        f1 = feature1.reshape(B, H * W, C)
        concat0 = torch.cat([f0, f1], dim=0)
        concat1 = torch.cat([f1, f0], dim=0)
        for i in range(self.num_layers):
            concat0 = getattr(self, f"layer{i}")(
                concat0, concat1, h=H, w=W, num_splits=num_splits,
                with_shift=num_splits > 1 and i % 2 == 1, attn_mask=mask)
            concat1 = torch.cat([concat0[B:], concat0[:B]], dim=0)
        return concat0[:B].reshape(B, H, W, C), concat0[B:].reshape(B, H, W, C)


def feature_add_position(feature0: torch.Tensor, feature1: torch.Tensor, num_splits: int,
                         channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both feature maps plus the sine position embedding
    (:func:`.position.position_embedding_sine`, ``channels // 2`` features
    per axis, in the features' dtype), taken per window when
    ``num_splits > 1``."""
    if num_splits > 1:
        f0, f1 = split_windows(feature0, num_splits), split_windows(feature1, num_splits)
        pos = position_embedding_sine(f0.shape[1], f0.shape[2], channels // 2, dtype=f0.dtype,
                                      device=f0.device)
        return merge_windows(f0 + pos, num_splits), merge_windows(f1 + pos, num_splits)
    pos = position_embedding_sine(feature0.shape[1], feature0.shape[2], channels // 2,
                                  dtype=feature0.dtype, device=feature0.device)
    return feature0 + pos, feature1 + pos


def global_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor):
    """The all-pairs correlation of ``(B, H, W, C)`` features (fp32 sums,
    scaled by ``C ** -0.5``), its softmax each way, the flows as the
    softmax-weighted pixel grid minus the grid, and the dual-softmax
    certainty: ``(f01, f10, dual_prob)``, the flows ``(B, H, W, 2)`` as
    ``(fx, fy)`` in the features' dtype, ``dual_prob (B, H*W, H*W)`` fp32
    (``prob01 * prob10^T``)."""
    B, H, W, C = feature0.shape
    f0 = feature0.reshape(B, H * W, C).float()
    f1 = feature1.reshape(B, H * W, C).float()
    corr = torch.matmul(f0, f1.transpose(1, 2)) * _inv_sqrt(C)
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=corr.device),
                            torch.arange(W, dtype=torch.float32, device=corr.device),
                            indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(1, H * W, 2)
    prob01 = torch.softmax(corr, dim=-1)
    prob10 = torch.softmax(corr.transpose(1, 2), dim=-1)
    f01 = (torch.matmul(prob01, grid.expand(B, -1, -1)) - grid).reshape(B, H, W, 2)
    f10 = (torch.matmul(prob10, grid.expand(B, -1, -1)) - grid).reshape(B, H, W, 2)
    dual_prob = prob01 * prob10.transpose(1, 2)
    return f01.to(feature0.dtype), f10.to(feature0.dtype), dual_prob
