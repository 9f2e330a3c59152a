"""Bilinear sampling and resizing (counterpart of ``videoframeinterpolation_tpu/ops/interp.py``).

NHWC throughout, sampling coordinates in pixel units with
``align_corners=True`` semantics (pixel ``i`` sits at coordinate ``i``);
``resize_bilinear`` also takes ``align_corners=False``, IFRNet's resize.
Sampling is written with floor, gather and weights as the JAX function is,
so the two agree tap for tap:

  * ``border`` clamps the continuous coordinate before the taps, as
    ``min(max(x, 0), W - 1)``, so that a coordinate on a bound passes half
    its gradient, as ``jnp.clip`` does;
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
        x = torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), W - 1))
        y = torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_full((), H - 1))

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
def _interp_weights(in_size: int, out_size: int, align_corners: bool = True) -> np.ndarray:
    """Static ``(out_size, in_size)`` 1-D linear-interpolation matrix. With
    ``align_corners=False`` the sample of output ``i`` lies at ``(i + 0.5)
    * in / out - 0.5``, clamped to ``[0, in - 1]``."""
    if out_size == 1:
        src = np.zeros((1,), np.float64)
    elif align_corners:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    mat[rows, lo] += 1.0 - w_hi
    mat[rows, hi] += w_hi
    return mat


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    align_corners: bool = True) -> torch.Tensor:
    """Separable bilinear resize of ``(B, H, W, C)`` to ``out_hw``
    (``F.interpolate(..., "bilinear", align_corners=...)``), with the same
    interpolation matrices as the JAX function."""
    B, H, W, C = x.shape
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    mh = torch.from_numpy(_interp_weights(H, Ho, align_corners)).to(x.device, x.dtype)
    mw = torch.from_numpy(_interp_weights(W, Wo, align_corners)).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("ow,bhwc->bhoc", mw, x)


@functools.lru_cache(maxsize=64)
def _antialias_weights(in_size: int, out_size: int) -> np.ndarray:
    """Static ``(out_size, in_size)`` matrix of ``jax.image.resize(...,
    "linear")`` along one axis: half-pixel centres, a triangle kernel
    widened by ``in / out`` when shrinking, each row normalised to sum 1,
    rows whose sample lies outside the input zero. Computed in float32, as
    JAX computes it (``jax._src.image.scale.compute_weight_mat``)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).T.astype(np.float32)


def resize_linear_antialias(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, *out_hw, C), "linear")`` of ``(B, H, W, C)``:
    separable, with :func:`_antialias_weights` along H and W (an axis whose
    size is unchanged is left alone, as JAX leaves it)."""
    B, H, W, C = x.shape
    Ho, Wo = out_hw
    if Ho != H:
        mh = torch.from_numpy(_antialias_weights(H, Ho)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", mh, x)
    if Wo != W:
        mw = torch.from_numpy(_antialias_weights(W, Wo)).to(x.device, x.dtype)
        x = torch.einsum("ow,bhwc->bhoc", mw, x)
    return x


def scale_resize(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Scale the spatial dims by ``scale_factor``; flow magnitudes are not
    rescaled (callers multiply where they mean to)."""
    B, H, W, C = x.shape
    return resize_bilinear(x, (int(H * scale_factor), int(W * scale_factor)))
