"""PSNR and the reference's 3-D SSIM (counterpart of ``videoframeinterpolation_tpu/eval/metrics.py``).

PSNR: ``-10 * log10(mse)`` over all pixels and channels of one image pair.

SSIM: an 11x11x11 Gaussian window convolved over (C, H, W), treated as the
three spatial dimensions of a single-channel 5-D volume, with replicate
padding of 5 on every axis. The window is built in float64 exactly as the
JAX package builds it, then cast to float32; everything else is float32.
Plain PyTorch (``F.pad`` and ``F.conv3d``): no hand-written kernel computes
either metric. On a CUDA device the caller switches TF32 off for cuDNN
(``torch.backends.cudnn.allow_tf32 = False``), or the convolutions keep
about three decimal digits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR of one image pair in [0, 1], a 0-d fp32 tensor."""
    mse = torch.mean((img1.float() - img2.float()) ** 2)
    return -10.0 * torch.log10(mse)


@functools.lru_cache(maxsize=4)
def _window_3d(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for x in range(window_size)], np.float64)
    g = g / g.sum()
    w1 = g[:, None]
    w2 = w1 @ w1.T
    w3 = w2[:, :, None] * g[None, None, :]
    return w3.astype(np.float32)


def _conv3d_replicate(vol: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Single-channel 3-D convolution of ``vol (B, 1, D, H, W)`` with
    ``window (1, 1, ws, ws, ws)``, replicate padding ``ws // 2`` on D, H, W."""
    pad = window.shape[-1] // 2
    return F.conv3d(F.pad(vol, (pad,) * 6, mode="replicate"), window)


def ssim_3d(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
            val_range: float | None = None) -> torch.Tensor:
    """SSIM of ``(B, H, W, C)`` images, averaged over the whole map; a 0-d
    fp32 tensor. Without ``val_range`` the dynamic range is read off
    ``img1`` (255 if its max exceeds 128, else 1; minus -1 if its min is
    below -0.5, else 0), as the reference does."""
    img1, img2 = img1.float(), img2.float()
    if val_range is None:
        max_val = torch.where(img1.max() > 128.0, 255.0, 1.0)
        min_val = torch.where(img1.min() < -0.5, -1.0, 0.0)
        L = max_val - min_val
    else:
        L = torch.tensor(val_range, dtype=torch.float32, device=img1.device)

    # NHWC -> (B, 1, C, H, W): channels become the leading spatial dim.
    v1 = img1.permute(0, 3, 1, 2)[:, None]
    v2 = img2.permute(0, 3, 1, 2)[:, None]
    window = torch.from_numpy(_window_3d(window_size)).to(img1.device)[None, None]

    mu1 = _conv3d_replicate(v1, window)
    mu2 = _conv3d_replicate(v2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _conv3d_replicate(v1 * v1, window) - mu1_sq
    sigma2_sq = _conv3d_replicate(v2 * v2, window) - mu2_sq
    sigma12 = _conv3d_replicate(v1 * v2, window) - mu1_mu2

    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    v1_ = 2.0 * sigma12 + C2
    v2_ = sigma1_sq + sigma2_sq + C2
    ssim_map = ((2.0 * mu1_mu2 + C1) * v1_) / ((mu1_sq + mu2_sq + C1) * v2_)
    return ssim_map.mean()
