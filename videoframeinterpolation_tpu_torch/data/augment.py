"""Geometric augmentations with an explicit generator (counterpart of ``videoframeinterpolation_tpu/data/augment.py``).

The pipeline works on an HWC stack ``[x0(3) | x1(3) | xt(3) | f0x(2) |
f1x(2)]`` (flow channels optional) and applies, in the reference's order:

  1. with probability 0.1, a 2x bilinear upscale (flow values doubled);
  2. a random crop to ``(crop_h, crop_w)``;
  3. with probability 0.5, RGB -> BGR on the three images;
  4. with probability 0.5, a vertical flip (flow ``fy`` negated);
  5. with probability 0.5, a horizontal flip (flow ``fx`` negated);
  6. a random 0-3 x 90-degree rotation (flow components rotated).

Every function but :func:`resize2x` is the JAX package's numpy code.
:func:`resize2x` computes in numpy what the JAX package's
``cv2.resize(..., fx=2, fy=2, INTER_LINEAR)`` computes on float32 (the
card's machine has no ``cv2``).
"""

from __future__ import annotations

import numpy as np

N_IMG_CH = 9  # x0 | x1 | xt


def _upsample2x_axis(a: np.ndarray, axis: int) -> np.ndarray:
    """OpenCV's linear 2x upsampling along ``axis`` in float32: half-pixel
    centres with the border replicated, so output ``2i`` is ``0.25 a[i-1] +
    0.75 a[i]`` and ``2i + 1`` is ``0.75 a[i] + 0.25 a[i+1]`` (the first and
    last output copy the border). Each is one float32 product per tap, the
    left tap's added first, as OpenCV's resize adds them."""
    a = np.moveaxis(a, axis, 0)
    n = a.shape[0]
    lo = np.concatenate([a[:1], a[:-1]])     # a[i-1], border replicated
    hi = np.concatenate([a[1:], a[-1:]])     # a[i+1]
    w1, w3 = np.float32(0.25), np.float32(0.75)
    even = lo * w1 + a * w3
    odd = a * w3 + hi * w1
    even[0] = a[0]
    odd[n - 1] = a[n - 1]
    out = np.empty((2 * n,) + a.shape[1:], np.float32)
    out[0::2] = even
    out[1::2] = odd
    return np.moveaxis(out, 0, axis)


def _resize2x_f32(x: np.ndarray) -> np.ndarray:
    """``cv2.resize(x, None, fx=2, fy=2, interpolation=INTER_LINEAR)`` of
    an HWC float32 array: rows first, then columns."""
    x = np.asarray(x, np.float32)
    return _upsample2x_axis(_upsample2x_axis(x, 1), 0)


def resize2x(frames: np.ndarray, with_flow: bool) -> np.ndarray:
    """2x bilinear upscale; flow magnitudes double (``data/base.py:207-212``)."""
    out = [_resize2x_f32(frames[:, :, i:i + 3]) for i in (0, 3, 6)]
    if with_flow:
        out.append(_resize2x_f32(frames[:, :, 9:]) * np.float32(2.0))
    return np.concatenate(out, axis=2)


def crop(frames: np.ndarray, h_off: int, w_off: int, ch: int, cw: int) -> np.ndarray:
    return frames[h_off:h_off + ch, w_off:w_off + cw, :]


def reverse_channels(frames: np.ndarray) -> np.ndarray:
    """RGB -> BGR on the three images only (``data/base.py:221-228``)."""
    out = frames.copy()
    for i in (0, 3, 6):
        out[:, :, i:i + 3] = frames[:, :, i + 2:None if i == 0 else i - 1:-1]
    return out


def vflip(frames: np.ndarray, with_flow: bool) -> np.ndarray:
    """Vertical flip; fy negated (``data/base.py:230-235``)."""
    out = frames[::-1, :, :].copy()
    if with_flow:
        out[:, :, 10] = -out[:, :, 10]
        out[:, :, 12] = -out[:, :, 12]
    return out


def hflip(frames: np.ndarray, with_flow: bool) -> np.ndarray:
    """Horizontal flip; fx negated (``data/base.py:237-242``)."""
    out = frames[:, ::-1, :].copy()
    if with_flow:
        out[:, :, 9] = -out[:, :, 9]
        out[:, :, 11] = -out[:, :, 11]
    return out


def rot90(frames: np.ndarray, k: int, with_flow: bool) -> np.ndarray:
    """k x 90-degree CCW rotation with flow component fixup
    (``data/base.py:244-255``): k=1 -> (fx,fy)<-(fy,-fx); k=2 -> negate;
    k=3 -> (fx,fy)<-(-fy,fx)."""
    out = np.rot90(frames, k, (0, 1)).copy()
    if with_flow and k:
        f = out[:, :, 9:]
        if k == 1:
            f = np.concatenate(
                (f[:, :, 1:2], -f[:, :, 0:1], f[:, :, 3:4], -f[:, :, 2:3]), 2)
        elif k == 2:
            f = -f
        elif k == 3:
            f = np.concatenate(
                (-f[:, :, 1:2], f[:, :, 0:1], -f[:, :, 3:4], f[:, :, 2:3]), 2)
        out[:, :, 9:] = f
    return out


def random_augment(rng: np.random.Generator, frames: np.ndarray, crop_hw: tuple[int, int],
                   with_flow: bool) -> np.ndarray:
    """The whole pipeline. The draws, in order: one ``uniform`` (resize),
    two ``integers`` (crop), three ``uniform`` (channels, flips), one
    ``integers`` (rotation), as in the JAX package."""
    if rng.uniform() < 0.1:
        frames = resize2x(frames, with_flow)
    h, w, _ = frames.shape
    ch, cw = crop_hw
    h_off = int(rng.integers(0, h - ch + 1))
    w_off = int(rng.integers(0, w - cw + 1))
    frames = crop(frames, h_off, w_off, ch, cw)
    if rng.uniform() < 0.5:
        frames = reverse_channels(frames)
    if rng.uniform() < 0.5:
        frames = vflip(frames, with_flow)
    if rng.uniform() < 0.5:
        frames = hflip(frames, with_flow)
    k = int(rng.integers(0, 4))
    frames = rot90(frames, k, with_flow)
    return np.ascontiguousarray(frames.astype(np.float32))
