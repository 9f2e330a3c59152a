"""Modulated deformable convolution (counterpart of ``videoframeinterpolation_tpu/ops/dcn.py``).

Plain PyTorch in this slice, as the JAX package left it to XLA: zeros-padded
bilinear samples through :func:`.interp.grid_sample`, modulated by the mask,
then one grouped contraction with the ``(G, K*K, Cin/G, Cout/G)`` weight,
summed in fp32 and rounded once to ``x``'s dtype before the bias is added.
On the main path it runs only at 1/16 resolution, in the query builder.
"""

from __future__ import annotations

import torch

from .interp import grid_sample
from .warp import base_grid


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor | None = None,
                  kernel_size: int = 3, padding: int = 1) -> torch.Tensor:
    """Stride-1 modulated deformable conv.

    Args:
      x: ``(B, H, W, Cin)``.
      offset: ``(B, H, W, G, K*K, 2)`` ``(dx, dy)`` pixel offsets.
      mask: ``(B, H, W, G, K*K)``.
      weight: ``(G, K*K, Cin/G, Cout/G)``, taps row-major ``(ky, kx)``.
      bias: ``(Cout,)`` or None.

    Returns:
      ``(B, H, W, Cout)``.
    """
    B, H, W, Cin = x.shape
    G, KK, Cg, CoutG = weight.shape
    K = kernel_size
    if KK != K * K or Cg * G != Cin:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)} with kernel_size {K}")
    grid = base_grid(H, W, x.device)[None, :, :, None, None]      # (1, H, W, 1, 1, 2)
    taps = base_grid(K, K, x.device).reshape(KK, 2) - padding     # (KK, 2) as (kx, ky)
    sx = grid[..., 0] + taps[:, 0] + offset[..., 0].float()       # (B, H, W, G, KK)
    sy = grid[..., 1] + taps[:, 1] + offset[..., 1].float()

    xg = x.reshape(B, H * W, G, Cg).permute(0, 2, 1, 3).reshape(B * G, H, W, Cg)
    coords = torch.stack([sx, sy], dim=-1).permute(0, 3, 1, 2, 4, 5)
    coords = coords.reshape(B * G, H * W * KK, 2)
    samples = grid_sample(xg, coords, padding_mode="zeros")
    samples = samples.reshape(B, G, H * W, KK, Cg)
    m = mask.permute(0, 3, 1, 2, 4).reshape(B, G, H * W, KK, 1).to(x.dtype)
    samples = samples * m
    out = torch.einsum("bgnkc,gkcd->bngd", samples.float(), weight.to(x.dtype).float())
    out = out.reshape(B, H, W, G * CoutG).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
