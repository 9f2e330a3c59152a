"""Backward and forward warping (counterpart of ``videoframeinterpolation_tpu/ops/warp.py``).

Flows are ``(..., 2)`` as ``(fx, fy)`` pixels, images NHWC. The forward
warps splat through :mod:`.softsplat`.
"""

from __future__ import annotations

import torch

from .interp import grid_sample
from .softsplat import softsplat, softsplat_raw, weak_constant


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


def fwarp(x: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None = None,
          mode: str = "soft") -> torch.Tensor:
    """Forward (splatting) warp; see :func:`.softsplat.softsplat`."""
    return softsplat(x, flow, metric, mode)


def _one_fdir(x: torch.Tensor, flow: torch.Tensor, td: torch.Tensor, metric: torch.Tensor):
    """One splat direction of the M2M merge: ``x * td * m`` and its weight
    ``td * m`` (``m = exp(clip(metric, -20, 20))``) splatted together;
    returns the splatted values and the weight plus 1e-7."""
    m = torch.exp(torch.clamp(metric, -20.0, 20.0))
    out = softsplat_raw(torch.cat([x * td * m, td * m], dim=-1), flow)
    return out[..., :-1], out[..., -1:] + weak_constant(1e-7, out)


def fwarp_using_two_frames(x0: torch.Tensor, flow0: torch.Tensor, t0: torch.Tensor,
                           x1: torch.Tensor, flow1: torch.Tensor, t1: torch.Tensor,
                           metric0: torch.Tensor, metric1: torch.Tensor):
    """Both frames splatted to one instant and merged: ``(blended,
    hole_mask)``, the mask flagging pixels whose summed weight is below
    1e-5. ``x (B, H, W, C)``, ``flow (B, H, W, 2)``, ``t`` broadcast
    against ``(B, H, W, 1)``, ``metric (B, H, W, 1)``."""
    out_f, norm_f = _one_fdir(x0, flow0, t0, metric0)
    out_b, norm_b = _one_fdir(x1, flow1, t1, metric1)
    norm = norm_f + norm_b
    return (out_f + out_b) / norm, norm < weak_constant(1e-5, norm)


def fwarp_mframes(x0: torch.Tensor, flows0: torch.Tensor, t0: torch.Tensor,
                  x1: torch.Tensor, flows1: torch.Tensor, t1: torch.Tensor,
                  metric0: torch.Tensor, metric1: torch.Tensor):
    """The M2M multi-branch merge: as :func:`fwarp_using_two_frames` with
    ``flows (n_branch, B, H, W, 2)`` and ``t (n_branch, B, 1, 1, 1)``, the
    frames and metrics shared by every branch; the branches are folded
    into the batch axis (one splat per direction) and summed."""
    nb, B, H, W, _ = flows0.shape
    C = x0.shape[-1]

    def fold(v):
        return v[None].expand(nb, *v.shape).reshape(nb * v.shape[0], *v.shape[1:])

    out_f, norm_f = _one_fdir(fold(x0), flows0.reshape(nb * B, H, W, 2),
                              t0.reshape(nb * B, 1, 1, 1), fold(metric0))
    out_b, norm_b = _one_fdir(fold(x1), flows1.reshape(nb * B, H, W, 2),
                              t1.reshape(nb * B, 1, 1, 1), fold(metric1))
    out = (out_f + out_b).reshape(nb, B, H, W, C).sum(dim=0)
    norm = (norm_f + norm_b).reshape(nb, B, H, W, 1).sum(dim=0)
    return out / norm, norm < weak_constant(1e-5, norm)
