"""Middlebury optical-flow colour rendering (counterpart of ``videoframeinterpolation_tpu/utils/flow_viz.py``).

The standard Baker et al. color wheel: 55 hues over RY/YG/GC/CB/BM/MR arcs,
saturation by normalized magnitude. Returns HWC uint8 RGB.
"""

from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """Render ``(H, W, 2)`` flow (fx, fy) as an ``(H, W, 3)`` uint8 image."""
    assert flow.ndim == 3 and flow.shape[2] == 2, flow.shape
    u = flow[:, :, 0].astype(np.float64)
    v = flow[:, :, 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate with magnitude
        img[:, :, i] = np.floor(255 * col)
    return img
