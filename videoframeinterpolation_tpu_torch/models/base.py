"""Shared model utilities (counterpart of ``videoframeinterpolation_tpu/models/base.py``)."""

from __future__ import annotations

import torch


def norm_w_rgb_mean(x0: torch.Tensor, x1: torch.Tensor):
    """Subtract the joint per-sample scalar mean of both frames.

    Returns ``(x0 - m, x1 - m, m)`` with ``m`` shaped ``(B, 1, 1, 1)``.
    """
    m0 = x0.mean(dim=(1, 2, 3), keepdim=True)
    m1 = x1.mean(dim=(1, 2, 3), keepdim=True)
    mean = 0.5 * (m0 + m1)
    return x0 - mean, x1 - mean, mean
