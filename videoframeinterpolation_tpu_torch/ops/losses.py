"""The training losses of the DAT family and IFRNet (counterpart of ``videoframeinterpolation_tpu/ops/losses.py``).

NHWC tensors, flows ``(..., 2)``. The census patches are extracted by a
convolution with an identity kernel, as in JAX. ``offset_fidelity_loss``
is not ported yet: no ported model reads it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def get_robust_weight(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                      beta: float) -> torch.Tensor:
    """``exp(-beta * EPE)`` of a detached prediction, ``(..., 1)``."""
    epe = torch.sqrt(((flow_pred.detach() - flow_gt) ** 2).sum(dim=-1, keepdim=True))
    return torch.exp(-beta * epe)


@functools.lru_cache(maxsize=8)
def _identity_patch_kernel(patch_size: int) -> np.ndarray:
    """``(P*P, 1, P, P)``: output channel k picks tap ``(k // P, k % P)``."""
    p2 = patch_size * patch_size
    return np.eye(p2, dtype=np.float32).reshape(p2, 1, patch_size, patch_size)


def _extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``(B, H, W, 1) -> (B, H, W, P*P)`` neighbourhood values, zero padded."""
    w = torch.from_numpy(_identity_patch_kernel(patch_size)).to(x.device, x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, padding=patch_size // 2)
    return out.permute(0, 2, 3, 1)


def _census_transform(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Soft census transform of a one-channel map."""
    loc_diff = _extract_patches(x, patch_size) - x
    return loc_diff / torch.sqrt(0.81 + loc_diff ** 2)


def _valid_mask(shape, patch_size: int, dtype, device) -> torch.Tensor:
    """``(B, H, W, 1)``: one inside a border of ``patch_size // 2``, zero on it."""
    pad = patch_size // 2
    B, H, W = shape[0], shape[1], shape[2]
    mask = torch.zeros((B, H, W, 1), dtype=dtype, device=device)
    mask[:, pad:H - pad, pad:W - pad] = 1
    return mask


def ternary_loss(x: torch.Tensor, y: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """Census loss on the grayscale means; ``y`` (the ground truth) is detached."""
    gx = x.mean(dim=-1, keepdim=True)
    gy = y.mean(dim=-1, keepdim=True)
    dx = _census_transform(gx, patch_size)
    dy = _census_transform(gy, patch_size).detach()
    diff = dx - dy
    dist = (diff ** 2 / (0.1 + diff ** 2)).mean(dim=-1, keepdim=True)
    return (dist * _valid_mask(x.shape, patch_size, x.dtype, x.device)).mean()


def geometry_loss(x: torch.Tensor, y: torch.Tensor, patch_size: int = 3) -> torch.Tensor:
    """Per-channel census loss between two feature maps ``(B, H, W, C)``
    over ``patch_size`` patches; neither side is detached (IFRNet's
    feature-vs-feature loss)."""
    if x.shape != y.shape:
        raise ValueError(f"geometry_loss: shapes differ, {tuple(x.shape)} and {tuple(y.shape)}")
    B, H, W, C = x.shape

    def transform(t):
        d = _census_transform(t.permute(0, 3, 1, 2).reshape(B * C, H, W, 1), patch_size)
        return d.reshape(B, C, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)

    diff = transform(x) - transform(y)
    dist = (diff ** 2 / (0.1 + diff ** 2)).mean(dim=-1, keepdim=True)
    return (dist * _valid_mask(x.shape, patch_size, x.dtype, x.device)).mean()


def charbonnier_l1(diff: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """``mean(sqrt(diff^2 + 1e-6))``, or its masked mean."""
    loss = torch.sqrt(diff ** 2 + 1e-6)
    if mask is None:
        return loss.mean()
    return (loss * mask).mean() / (mask.mean() + 1e-9)


def charbonnier_ada(diff: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weight-adaptive Charbonnier: ``alpha = w / 2``, ``eps = 10^(-(10w - 1)/3)``."""
    alpha = weight / 2.0
    epsilon = torch.pow(10.0, -(10.0 * weight - 1.0) / 3.0)
    return ((diff ** 2 + epsilon ** 2) ** alpha).mean()
