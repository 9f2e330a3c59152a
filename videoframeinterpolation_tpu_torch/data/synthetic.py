"""Procedural-motion triplet generator with exact ground-truth flows.

Counterpart of ``videoframeinterpolation_tpu/data/synthetic.py``, kept as
a copy because the port imports nothing of the JAX package. It is numpy
only and must give the same bytes as the JAX package's generator for the
same ``(seed, split, index)``: every item draws from
``PCG64([seed, split, index])`` in the same order, with the same dtypes.

Each item is a layered scene:

  * a background texture moving with one affine map, plus 1-3 foreground
    layers (soft-edged elliptical sprites) moving with independent affine
    maps (translation + rotation + scale) — occlusion boundaries included;
  * frames x0, x1, xt are renderings of the same scene at times 0, 1, t
    (textures sampled from an extended canvas so no frame "invents"
    content at the borders);
  * f0x / f1x are the *exact* flows t->0 and t->1 of the visible surface
    (alpha-blended at occlusion boundaries), stored with the same 1/255
    scaling quirk as the Vimeo90K pipeline.

Items are dicts with ``x0/x1/xt/t/f0x/f1x``; train and held-out splits
are reproducible and disjoint. The held-out pool of the quality study
(``tools/eval_best.py:build_pool``) is drawn from it.
"""

from __future__ import annotations

import numpy as np


def _bilinear_sample(tex: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Sample ``tex`` (H, W, C) at float coords, border-clamped. Returns
    an array shaped like ``ys`` plus a channel axis."""
    H, W = tex.shape[:2]
    ys = np.clip(ys, 0.0, H - 1.0)
    xs = np.clip(xs, 0.0, W - 1.0)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    v00 = tex[y0, x0]
    v01 = tex[y0, x1]
    v10 = tex[y1, x0]
    v11 = tex[y1, x1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _value_noise(rng: np.random.Generator, h: int, w: int, channels: int,
                 octaves: int = 4, base_cells: int = 4) -> np.ndarray:
    """Multi-octave bilinear value noise in [0, 1], (h, w, channels)."""
    out = np.zeros((h, w, channels), np.float32)
    amp_total = 0.0
    for o in range(octaves):
        cells = base_cells * (2 ** o)
        gh, gw = min(cells, h) + 1, min(cells, w) + 1
        grid = rng.random((gh, gw, channels), dtype=np.float32)
        ys = np.linspace(0.0, gh - 1.0, h, dtype=np.float32)
        xs = np.linspace(0.0, gw - 1.0, w, dtype=np.float32)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        amp = 0.55 ** o
        out += amp * _bilinear_sample(grid, yy, xx)
        amp_total += amp
    return out / amp_total


def _affine(rng: np.random.Generator, max_shift: float, max_rot_deg: float,
            scale_range: tuple[float, float], center: tuple[float, float]):
    """A 2x3 affine map (pixel coords -> pixel coords) about ``center``."""
    ang = np.deg2rad(rng.uniform(-max_rot_deg, max_rot_deg))
    s = rng.uniform(*scale_range)
    c, si = np.cos(ang) * s, np.sin(ang) * s
    R = np.array([[c, -si], [si, c]], np.float64)
    cx, cy = center
    shift = rng.uniform(-max_shift, max_shift, size=2)
    # p' = R (p - center) + center + shift
    M = np.zeros((2, 3), np.float64)
    M[:, :2] = R
    M[:, 2] = np.array([cx, cy]) - R @ np.array([cx, cy]) + shift
    return M


def _apply_affine(M: np.ndarray, xx: np.ndarray, yy: np.ndarray):
    """Apply a 2x3 map to pixel coords; returns (x', y')."""
    xo = M[0, 0] * xx + M[0, 1] * yy + M[0, 2]
    yo = M[1, 0] * xx + M[1, 1] * yy + M[1, 2]
    return xo, yo


def _lerp_affine(M0: np.ndarray, M1: np.ndarray, t: float) -> np.ndarray:
    return (1.0 - t) * M0 + t * M1


def _invert_affine(M: np.ndarray) -> np.ndarray:
    A = M[:, :2]
    b = M[:, 2]
    Ai = np.linalg.inv(A)
    out = np.zeros((2, 3), np.float64)
    out[:, :2] = Ai
    out[:, 2] = -Ai @ b
    return out


class _Layer:
    """One moving surface: texture + time-interpolated affine + alpha."""

    def __init__(self, tex: np.ndarray, M0: np.ndarray, M1: np.ndarray,
                 ellipse: tuple | None, pad: float):
        self.tex = tex
        self.M0 = M0  # pixel coords (frame at t=0 ... ) -> texture coords
        self.M1 = M1
        self.ellipse = ellipse  # (cx, cy, rx, ry, softness) in TEXTURE coords
        self.pad = pad

    def M(self, t: float) -> np.ndarray:
        return _lerp_affine(self.M0, self.M1, t)

    def render(self, xx: np.ndarray, yy: np.ndarray, t: float):
        """Color (H, W, 3) and alpha (H, W, 1) of this layer at time t."""
        u, v = _apply_affine(self.M(t), xx, yy)  # texture coords
        color = _bilinear_sample(self.tex, v + self.pad, u + self.pad)
        if self.ellipse is None:
            alpha = np.ones((*xx.shape, 1), np.float32)
        else:
            cx, cy, rx, ry, soft = self.ellipse
            d = np.sqrt(((u - cx) / rx) ** 2 + ((v - cy) / ry) ** 2)
            alpha = np.clip((1.0 - d) / soft, 0.0, 1.0)[..., None]
        return color.astype(np.float32), alpha.astype(np.float32)

    def flow_to(self, xx: np.ndarray, yy: np.ndarray, t_from: float,
                t_to: float):
        """Exact displacement (fx, fy) of this layer's surface points from
        their position at ``t_from`` to their position at ``t_to``."""
        u, v = _apply_affine(self.M(t_from), xx, yy)
        Minv = _invert_affine(self.M(t_to))
        x_to, y_to = _apply_affine(Minv, u, v)
        return (x_to - xx).astype(np.float32), (y_to - yy).astype(np.float32)


class SyntheticMotion:
    """Procedural layered-motion triplets with exact GT flows.

    Drop-in for the dataset registry: items match ``Vimeo90KwFlow``'s
    (``x0/x1/xt/t/f0x/f1x``). ``root`` is accepted and ignored.
    """

    def __init__(
        self,
        root: str = "",
        crop_hw: tuple[int, int] = (256, 256),
        is_train: bool = True,
        seed: int = 0,
        num_items: int = 64_000,
        max_shift: float = 14.0,
        max_rot_deg: float = 4.0,
        n_fg_range: tuple[int, int] = (1, 3),
        flow_in_pixels: bool = False,
        random_t: bool | tuple[float, float] = False,
        fixed_t: float | None = None,
    ):
        del root
        self.crop_hw = tuple(crop_hw)
        self.is_train = is_train
        self.base_seed = seed
        self.num_items = num_items
        self.max_shift = max_shift
        self.max_rot_deg = max_rot_deg
        self.n_fg_range = n_fg_range
        self.flow_scale = 1.0 if flow_in_pixels else 1.0 / 255.0
        # random_t: False → t=0.5 (reference Vimeo90K protocol,
        # data/Vimeo90K.py:37); True → uniform in (0.3, 0.7) (legacy);
        # (lo, hi) tuple → uniform in that range (e.g. (0.125, 0.875)
        # covers the factor-8 serving instants). fixed_t overrides both
        # WITHOUT consuming the rng draw, so per-instant eval pools built
        # at different fixed_t share byte-identical scene geometry.
        self.t_range = ((0.3, 0.7) if random_t is True
                        else tuple(random_t) if random_t else None)
        self.fixed_t = fixed_t

    def __len__(self) -> int:
        return self.num_items

    def seed(self, seed: int) -> None:
        """Loader-worker reseed hook (epoch shuffling is index-driven for
        this dataset; items are a pure function of the index)."""
        del seed

    def _item_rng(self, idx: int) -> np.random.Generator:
        split = 0 if self.is_train else 1
        return np.random.Generator(
            np.random.PCG64([self.base_seed, split, idx])
        )

    def _build_scene(self, rng: np.random.Generator, H: int, W: int):
        pad = int(np.ceil(self.max_shift)) + 8
        layers = []
        # Background: full-canvas texture, gentle affine.
        bg_tex = _value_noise(rng, H + 2 * pad, W + 2 * pad, 3)
        center = (W / 2.0, H / 2.0)
        M0 = _affine(rng, self.max_shift * 0.5, self.max_rot_deg * 0.5,
                     (0.98, 1.02), center)
        M1 = _affine(rng, self.max_shift * 0.5, self.max_rot_deg * 0.5,
                     (0.98, 1.02), center)
        layers.append(_Layer(bg_tex, M0, M1, None, pad))

        n_fg = int(rng.integers(self.n_fg_range[0], self.n_fg_range[1] + 1))
        for _ in range(n_fg):
            tex = _value_noise(rng, H + 2 * pad, W + 2 * pad, 3,
                               base_cells=8)
            # Distinct tint so layers are visually separable.
            tint = rng.uniform(0.4, 1.0, size=3).astype(np.float32)
            tex = tex * tint + rng.uniform(0.0, 0.3)
            cx = rng.uniform(0.15 * W, 0.85 * W)
            cy = rng.uniform(0.15 * H, 0.85 * H)
            rx = rng.uniform(0.10, 0.30) * W
            ry = rng.uniform(0.10, 0.30) * H
            soft = rng.uniform(0.05, 0.25)
            Mf0 = _affine(rng, self.max_shift, self.max_rot_deg,
                          (0.95, 1.05), (cx, cy))
            Mf1 = _affine(rng, self.max_shift, self.max_rot_deg,
                          (0.95, 1.05), (cx, cy))
            layers.append(_Layer(tex, Mf0, Mf1, (cx, cy, rx, ry, soft), pad))
        return layers

    @staticmethod
    def _composite(layers, xx, yy, t: float):
        """Back-to-front alpha composite; returns color and per-layer
        visibility weights."""
        H, W = xx.shape
        color = np.zeros((H, W, 3), np.float32)
        weights = []
        for layer in layers:
            c, a = layer.render(xx, yy, t)
            color = color * (1.0 - a) + c * a
            weights = [w * (1.0 - a) for w in weights]
            weights.append(a)
        return np.clip(color, 0.0, 1.0), weights

    def _flow(self, layers, weights, xx, yy, t_from: float, t_to: float):
        H, W = xx.shape
        f = np.zeros((H, W, 2), np.float32)
        for layer, w in zip(layers, weights):
            fx, fy = layer.flow_to(xx, yy, t_from, t_to)
            f += w * np.stack([fx, fy], axis=-1)
        return f

    def __getitem__(self, idx: int) -> dict:
        return self.item(idx)

    def item(self, idx: int, frame_flows: bool = False) -> dict:
        """Item ``idx`` (``self[idx]``); with ``frame_flows`` also ``f01``
        and ``f10``, the true flows between its two frames: frame 0 ->
        frame 1 at frame 0's pixels, and frame 1 -> frame 0 at frame 1's,
        derived as ``f0x`` and ``f1x`` are, as each layer's displacement
        between the two times weighted by the layers' visibility in the
        frame the flow starts from, and scaled as they are. So ``x1``
        sampled at ``p + f01(p)`` is ``x0`` wherever the surface seen at
        ``p`` stays visible."""
        rng = self._item_rng(idx)
        H, W = self.crop_hw
        layers = self._build_scene(rng, H, W)
        if self.fixed_t is not None:
            t = float(self.fixed_t)
        elif self.t_range is not None:
            t = float(rng.uniform(*self.t_range))
        else:
            t = 0.5

        yy, xx = np.meshgrid(
            np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
            indexing="ij",
        )
        x0, w0 = self._composite(layers, xx, yy, 0.0)
        x1, w1 = self._composite(layers, xx, yy, 1.0)
        xt, wt = self._composite(layers, xx, yy, t)
        f0x = self._flow(layers, wt, xx, yy, t, 0.0) * self.flow_scale
        f1x = self._flow(layers, wt, xx, yy, t, 1.0) * self.flow_scale
        out = {
            "x0": x0,
            "x1": x1,
            "xt": xt,
            "t": np.full((1, 1, 1), t, np.float32),
            "f0x": f0x.astype(np.float32),
            "f1x": f1x.astype(np.float32),
        }
        if frame_flows:
            out["f01"] = (self._flow(layers, w0, xx, yy, 0.0, 1.0)
                          * self.flow_scale).astype(np.float32)
            out["f10"] = (self._flow(layers, w1, xx, yy, 1.0, 0.0)
                          * self.flow_scale).astype(np.float32)
        return out
