"""Backward warping (counterpart of ``videoframeinterpolation_tpu/ops/warp.py:bwarp``)."""

from __future__ import annotations

import torch

from .interp import grid_sample


def base_grid(H: int, W: int, device, stride: int = 1) -> torch.Tensor:
    """``(H, W, 2)`` pixel positions as ``(x, y)``, float32. With ``stride``
    the ``H x W`` grid is a query grid ``stride`` times coarser than the
    pixels: position ``j * stride + (stride - 1) / 2``, the centre of each
    ``stride x stride`` cell, exact in fp32 as JAX forms it
    (``videoframeinterpolation_tpu/nn/deformable_attn.py:108-114``)."""
    half = (stride - 1) / 2.0
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) * stride + half,
        torch.arange(W, dtype=torch.float32, device=device) * stride + half,
        indexing="ij",
    )
    return torch.stack([gx, gy], dim=-1)


def bwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample ``img (B, H, W, C)`` at ``p + flow(p)``: bilinear, border
    padding, align_corners=True."""
    B, H, W, _ = flow.shape
    coords = base_grid(H, W, flow.device)[None] + flow.float()
    return grid_sample(img, coords, padding_mode="border")
