"""Pixel shuffle in NHWC (counterpart of ``videoframeinterpolation_tpu/ops/pixelshuffle.py``).

Channel order matches ``torch.nn.PixelShuffle``:
``out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]``.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """``(B, H, W, C*r*r) -> (B, H*r, W*r, C)``."""
    B, H, W, Crr = x.shape
    C = Crr // (r * r)
    if C * r * r != Crr:
        raise ValueError(f"channels {Crr} not divisible by {r * r}")
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)
