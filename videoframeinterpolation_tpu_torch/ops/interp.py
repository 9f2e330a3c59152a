"""Bilinear sampling and resizing (counterpart of ``videoframeinterpolation_tpu/ops/interp.py``).

NHWC throughout, coordinates in pixel units with ``align_corners=True``
semantics (pixel ``i`` sits at coordinate ``i``). Written with floor,
gather and weights as the JAX function is, so the two agree tap for tap:

  * ``border`` clamps the continuous coordinate before the taps;
  * ``zeros`` masks each tap by ``0 <= xi <= W-1`` and ``0 <= yi <= H-1``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "border") -> torch.Tensor:
    """Bilinear sampling of ``img`` at fractional pixel coordinates.

    Args:
      img: ``(B, H, W, C)``.
      coords: ``(B, ..., 2)`` as ``(x, y)`` pixels.
      padding_mode: ``"border"`` (bwarp) or ``"zeros"`` (the deformable
        sampler and DCN).

    Returns:
      ``(B, ..., C)``, the leading shape of ``coords``.
    """
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    B, H, W, C = img.shape
    lead = coords.shape[:-1]
    coords = coords.reshape(B, -1, 2)
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(img.dtype)[..., None]
    wy = (y - y0f).to(img.dtype)[..., None]
    # Clamped before the integer cast so far-away coordinates cannot
    # overflow; the clamp range keeps every mask decision unchanged.
    x0 = x0f.clamp(-2, W + 1).long()
    y0 = y0f.clamp(-2, H + 1).long()

    flat = img.reshape(B, H * W, C)
    bidx = torch.arange(B, device=img.device)[:, None]

    def tap(xi, yi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat[bidx, idx]
        if padding_mode == "zeros":
            m = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            return v, m.to(img.dtype)[..., None]
        return v, None

    v00, m00 = tap(x0, y0)
    v01, m01 = tap(x0 + 1, y0)
    v10, m10 = tap(x0, y0 + 1)
    v11, m11 = tap(x0 + 1, y0 + 1)
    w00 = (1.0 - wx) * (1.0 - wy)
    w01 = wx * (1.0 - wy)
    w10 = (1.0 - wx) * wy
    w11 = wx * wy
    if padding_mode == "zeros":
        w00 = w00 * m00
        w01 = w01 * m01
        w10 = w10 * m10
        w11 = w11 * m11
    out = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11
    return out.reshape(B, *lead[1:], C)


@functools.lru_cache(maxsize=64)
def _interp_weights(in_size: int, out_size: int) -> np.ndarray:
    """Static ``(out_size, in_size)`` 1-D linear-interpolation matrix,
    align_corners=True."""
    if out_size == 1:
        src = np.zeros((1,), np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    mat[rows, lo] += 1.0 - w_hi
    mat[rows, hi] += w_hi
    return mat


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Separable bilinear resize (align_corners=True) of ``(B, H, W, C)`` to
    ``out_hw``, with the same interpolation matrices as the JAX function."""
    B, H, W, C = x.shape
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    mh = torch.from_numpy(_interp_weights(H, Ho)).to(x.device, x.dtype)
    mw = torch.from_numpy(_interp_weights(W, Wo)).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("ow,bhwc->bhoc", mw, x)


def scale_resize(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Scale the spatial dims by ``scale_factor``; flow magnitudes are not
    rescaled (callers multiply where they mean to)."""
    B, H, W, C = x.shape
    return resize_bilinear(x, (int(H * scale_factor), int(W * scale_factor)))
