"""DETR-style sine position embedding (counterpart of ``videoframeinterpolation_tpu/nn/position.py``)."""

from __future__ import annotations

import functools
import math

import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0, normalize: bool = True,
                            scale: float | None = None, dtype: torch.dtype = torch.float32,
                            device: torch.device | str | None = None) -> torch.Tensor:
    """``(1, h, w, 2 * num_pos_feats)``, the y-features before the
    x-features. Each axis's running count (fp32), normalised by its last
    row or column (plus 1e-6) times ``scale`` (2 pi), is divided by
    ``temperature ** (2 * floor(i / 2) / num_pos_feats)``; feature ``2k``
    is the sine of the even quotient and ``2k + 1`` the cosine of the odd
    one, cast to ``dtype`` at the end.

    The quotients are JAX's fp32 values bit for bit. Their sines and
    cosines are taken in float64 and rounded to fp32 once, so the CPU and
    the card give the same embedding; XLA's CPU sine and cosine are
    approximations of their own, which differ from these by at most one
    fp32 ulp. The embedding is a constant of its shape: it is built once
    per shape, dtype and device and reused (a normal tensor even when first
    asked for under ``torch.inference_mode``, so that training can use it
    too)."""
    with torch.inference_mode(False):
        return _embedding(h, w, num_pos_feats, float(temperature), normalize, scale, dtype,
                          torch.device(device) if device is not None else torch.device("cpu"))


@functools.lru_cache(maxsize=32)
def _embedding(h, w, num_pos_feats, temperature, normalize, scale, dtype, device):
    if device.type != "cpu":
        return _embedding(h, w, num_pos_feats, temperature, normalize, scale, dtype,
                          torch.device("cpu")).to(device)
    if scale is None:
        scale = 2 * math.pi
    ones = torch.ones((h, w), dtype=torch.float32)
    y_embed = torch.cumsum(ones, dim=0)
    x_embed = torch.cumsum(ones, dim=1)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def embed(e):
        q = (e[:, :, None] / dim_t).double()
        return torch.stack([torch.sin(q[:, :, 0::2]), torch.cos(q[:, :, 1::2])],
                           dim=3).reshape(h, w, -1).float()

    return torch.cat([embed(y_embed), embed(x_embed)], dim=-1)[None].to(dtype)
