"""Swin-style windowed cross-attention decoders (counterpart of ``videoframeinterpolation_tpu/nn/swin.py``).

``WindowAttention`` attends each window of a query map onto the same
window of a source map, with a learned relative position bias;
``SwinIRBlock`` wraps it (zero padding to whole windows, an optional cyclic
shift with its region mask, a merge projection, a LayerNorm and an MLP);
``SwinBasicLayer`` applies one block per depth to the query against both
frames and mixes the two results with a conv; ``SwinDecoder`` adds an
optional ConvTranspose 2x head.

The products are plain ``torch.matmul`` calls (cuBLAS on the card, no
hand-written kernel: no Pallas kernel computes them in the JAX package).
As in JAX, both products take operands in the compute dtype and sum in
fp32, the bias and the mask are added and the softmax taken in fp32, and
the probabilities and the attended values are rounded to the compute
dtype. Two sums that JAX writes in the compute dtype are not rounded, as
XLA fuses each into an fp32 consumer (``tests/test_torch_dcntrans.py``
holds both): the scaled queries and ``mlp2``'s bias add.
Both frames of a depth run in one call of its block, on the batch axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (Dense, Float32Params, LayerNorm, PReLU, conv, conv_transpose_x2, gelu,
                     trunc_normal_02)


@functools.lru_cache(maxsize=16)
def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """``(N, N)`` row of the bias table for each query and key of a
    ``wh x ww`` window (``N = wh * ww``)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def _shift_attn_mask(hp: int, wp: int, ws: int, ss: int) -> np.ndarray:
    """The shifted windows' additive mask ``(nW, N, N)``: -100 between
    tokens of different regions of the rolled map, else 0."""
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = m[:, None, :] - m[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (a numpy constant of its shape) as a tensor on
    ``device``, made once per shape and device (a normal tensor even when
    first asked for under ``torch.inference_mode``, so that training can
    use it too)."""
    with torch.inference_mode(False):
        return torch.from_numpy(fn(*args)).to(device)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``(B, H, W, C) -> (B * nW, ws, ws, C)``, windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(win: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    x = win.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class WindowAttention(Float32Params, nn.Module):
    """Cross attention within ``window x window`` windows with a relative
    position bias: ``q_proj`` of the queries, the fused ``kv_proj`` of the
    source (keys, then values), ``num_heads`` heads, the queries scaled by
    ``hc ** -0.5`` (rounded to the compute dtype) after the projection.
    The bias table ``((2w - 1)^2, heads)`` is fp32 in every compute dtype."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.q_proj = Dense(dim, dim, kernel_init=trunc_normal_02)
        self.kv_proj = Dense(dim, 2 * dim, kernel_init=trunc_normal_02)
        self.proj = Dense(dim, dim, kernel_init=trunc_normal_02)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        trunc_normal_02(self.relative_position_bias_table)

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``q, kv (B_, N, C)`` with ``N = window^2``; ``mask (nW, N, N)``
        for the windows of one image, ``B_`` a multiple of ``nW``."""
        B_, N, C = q.shape
        nh = self.num_heads
        hc = C // nh
        scale = torch.tensor(hc ** -0.5, dtype=q.dtype).item()
        k, v = self.kv_proj(kv).split(self.dim, dim=-1)
        # XLA multiplies the projection by the rounded scale in fp32 inside
        # the product that reads it in fp32: the scaled queries are never
        # rounded to the compute dtype.
        qp = self.q_proj(q).reshape(B_, N, nh, hc).transpose(1, 2).float() * scale
        k = k.reshape(B_, N, nh, hc).transpose(1, 2)
        v = v.reshape(B_, N, nh, hc).transpose(1, 2)
        attn = torch.matmul(qp, k.float().transpose(-1, -2))

        idx = _on_device(_relative_position_index, (self.window, self.window), q.device)
        bias = self.relative_position_bias_table.float()[idx.reshape(-1)]
        attn = attn + bias.reshape(N, N, nh).permute(2, 0, 1)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N) + mask[None, :, None]).reshape(
                B_, nh, N, N)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float())
        return self.proj(out.transpose(1, 2).reshape(B_, N, C).to(q.dtype))


class SwinIRBlock(nn.Module):
    """(Shifted-)window cross attention of a query map ``x`` onto ``feat``,
    then ``merge`` (no bias), ``norm1`` and the residual, then ``mlp1``,
    exact GELU, ``mlp2``, ``norm2`` and the residual.

    The window is ``ws = min(window_size, H, W)``, and the shift is used
    only at the full window. Both maps are zero padded to whole windows;
    the padded tokens take part in the attention unmasked (their keys and
    values are the projection's bias), as in JAX. Flax shapes the bias
    table by the first input, so a block built for inputs whose smaller
    side is below ``window_size`` takes ``smallest_side``, and an input
    that would need another table raises."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 4, shift_size: int = 0,
                 mlp_ratio: float = 4.0, smallest_side: int | None = None):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        window = min(window_size, smallest_side) if smallest_side else window_size
        self.attn = WindowAttention(dim, window, num_heads)
        self.merge = Dense(dim, dim, bias=False, kernel_init=trunc_normal_02)
        self.norm1 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp1 = Dense(dim, hidden, kernel_init=trunc_normal_02)
        self.mlp2 = Dense(hidden, dim, kernel_init=trunc_normal_02)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = min(self.window_size, H, W)
        if ws != self.attn.window:
            raise ValueError(f"a {H}x{W} input takes {ws}x{ws} windows; this block's "
                             f"relative position table is for {self.attn.window}x"
                             f"{self.attn.window} (build it with smallest_side={min(H, W)})")
        ss = self.shift_size if ws == self.window_size else 0
        shortcut = x
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            feat = F.pad(feat, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            feat = torch.roll(feat, (-ss, -ss), dims=(1, 2))
            mask = _on_device(_shift_attn_mask, (Hp, Wp, ws, ss), x.device)
        xw = window_partition(x, ws).reshape(-1, ws * ws, C)
        fw = window_partition(feat, ws).reshape(-1, ws * ws, C)
        x = window_reverse(self.attn(xw, fw, mask), ws, B, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
        x = x[:, :H, :W]
        x = shortcut + self.norm1(self.merge(x))
        # XLA adds mlp2's bias in fp32 inside norm2, which reads it in fp32:
        # the sum is never rounded to the compute dtype.
        h = self.mlp2.product(gelu(self.mlp1(x))).float() + self.mlp2.bias.to(x.dtype).float()
        return x + self.norm2(h).to(x.dtype)


class SwinBasicLayer(nn.Module):
    """Per depth ``i``: block ``block{i}`` (shifted by ``window_size // 2``
    when ``i`` is odd) attends the query onto the source and onto the
    target, and ``mixer{i}`` (a conv of the two results) with
    ``mixer{i}_prelu`` makes the next query."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", SwinIRBlock(
                dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                mlp_ratio))
            self.add_module(f"mixer{i}", conv(2 * dim, dim))
            self.add_module(f"mixer{i}_prelu", PReLU(dim))

    def forward(self, x: torch.Tensor, source: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        frames = torch.cat([source, target], dim=0)
        for i in range(self.depth):
            ab = getattr(self, f"block{i}")(torch.cat([x, x], dim=0), frames)
            h = getattr(self, f"mixer{i}")(torch.cat([ab[:B], ab[B:]], dim=-1))
            x = getattr(self, f"mixer{i}_prelu")(h)
        return x


class SwinDecoder(nn.Module):
    """A :class:`SwinBasicLayer` (``transformer``), with an optional
    ConvTranspose 2x head to ``upsample_to`` channels (``upconv``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, upsample_to: int | None = None):
        super().__init__()
        self.transformer = SwinBasicLayer(dim, depth, num_heads, window_size, mlp_ratio)
        self.upconv = conv_transpose_x2(dim, upsample_to) if upsample_to is not None else None

    def forward(self, x: torch.Tensor, source: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        x = self.transformer(x, source, target)
        return x if self.upconv is None else self.upconv(x)
