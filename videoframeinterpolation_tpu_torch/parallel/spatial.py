"""Spatially tiled HD inference on one card (counterpart of ``videoframeinterpolation_tpu/parallel/spatial.py``).

A frame pair larger than a tile is cut into overlapping tiles, which ride
the batch axis in chunks of ``tile_batch``; the predictions are blended
back with feathered weights. The overlap must cover the model's sampling
reach: its flow plus the deformable offsets' bound. :func:`make_flow_aware_tiled`
sizes it per pair from the model's own flow estimate on a 1/4-scale copy
of the frames (:func:`make_flow_probe`), and runs a pair full-frame, with
a warning, when no tile of the given size can hold that reach.

The functions keep the JAX package's names, arguments and tile order. As
there, ``params`` is passed through to ``apply_fn``; in the port it is the
model itself (``apply_fn = lambda m, a, b, t: m(a, b, t)``). The blend is
accumulated in the prediction's dtype, tile by tile in the JAX order, so
that for the same predictions the two blends agree to the rounding of
their sums. Halo-exchange sharding across cards (``make_sharded_infer``)
and the ``mesh`` argument are not ported yet and raise.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.interp import resize_linear_antialias

# Max full-resolution displacement of the flagship's deformable sampler
# beyond its predicted flow: tanh-bounded residuals scaled by offset_scale
# (2/4/8 at levels of stride 8/4/2), 16 px at every level.
FLAGSHIP_OFFSET_REACH_PX = 16.0
# Pyramid levels lv1..lv4 of ``pred_ft0`` / ``pred_ft1`` and their strides.
_STRIDES = (2.0, 4.0, 8.0, 16.0)
_MULTI_GPU = ("halo-exchange sharding across cards is not ported yet (ROADMAP.md, queue 1 "
              "item 10)")


def _probe_hw(H: int, W: int, downscale: int) -> tuple[int, int]:
    return (max(32, int(round(H / downscale / 16)) * 16),
            max(32, int(round(W / downscale / 16)) * 16))


@torch.inference_mode()
def estimate_flow_magnitude(apply_fn: Callable, params, x0: torch.Tensor, x1: torch.Tensor,
                            t: torch.Tensor, *, downscale: int = 4,
                            safety: float = 1.25) -> float:
    """The max full-resolution flow magnitude (px) of one frame pair.

    Runs ``apply_fn(..., train=True)`` on a ``downscale``-reduced copy of
    the frames and reads its flow pyramids, each in its level's pixel
    units: full-resolution magnitude = level value x level stride x
    ``downscale``, inflated by ``safety``. Raises TypeError/KeyError when
    ``apply_fn`` exposes no flow pyramids."""
    hh, ww = _probe_hw(*x0.shape[1:3], downscale)
    _, inter = apply_fn(params, resize_linear_antialias(x0, (hh, ww)),
                        resize_linear_antialias(x1, (hh, ww)), t, train=True)
    mags = [flow.abs().max().float() * s for key in ("pred_ft0", "pred_ft1")
            for flow, s in zip(inter[key], _STRIDES)]
    return float(torch.stack(mags).max()) * downscale * safety


def required_overlap(flow_mag_px: float, *, offset_reach_px: float = FLAGSHIP_OFFSET_REACH_PX,
                     feather_px: int = 16, quantize: int = 16) -> tuple[int, int]:
    """(overlap, trim) in px that make tiled inference seam-safe.

    A pixel closer than ``flow + offset_reach`` to a tile's cut edge
    samples the tile's padding, so the blend gives it zero weight
    (``trim``) and ramps across a further ``feather_px``; every pixel needs
    some tile that keeps it, so the overlap is at least ``2 * trim``. Both
    are rounded up to multiples of ``quantize`` and 16, so that nearby
    magnitudes share a plan."""
    q = max(1, quantize)
    trim = int(math.ceil((flow_mag_px + offset_reach_px) / q)) * q
    overlap = int(math.ceil(max(trim + feather_px, 2 * trim) / 16.0)) * 16
    return overlap, trim


def make_flow_probe(train_apply_fn: Callable, *, downscale: int = 4,
                    safety: float = 1.25) -> Callable:
    """``probe(params, x0, x1, t) -> float``, the max-flow estimate (px) of
    :func:`estimate_flow_magnitude` with one host read per pair."""

    def probe(params, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> float:
        return estimate_flow_magnitude(train_apply_fn, params, x0, x1, t,
                                       downscale=downscale, safety=safety)

    return probe


def check_overlap(overlap: int, trim: Optional[int], flow_mag_px: float, tile: int, *,
                  offset_reach_px: float = FLAGSHIP_OFFSET_REACH_PX) -> None:
    """Warn when a tiling plan cannot be seam-free for the given motion."""
    reach = flow_mag_px + offset_reach_px
    eff_trim = (overlap // 4) if trim is None else trim
    if eff_trim < reach:
        warnings.warn(
            f"tile overlap {overlap} (trim {eff_trim}) < sampling reach "
            f"{reach:.0f} px (flow {flow_mag_px:.0f} + offsets "
            f"{offset_reach_px:.0f}); seams possible — grow --tile overlap "
            f"or use halo sharding (make_sharded_infer)", stacklevel=2)
    if overlap >= tile // 2:
        warnings.warn(
            f"overlap {overlap} >= tile/2 ({tile // 2}): tiles mostly "
            f"recompute each other; use a larger tile", stacklevel=2)


def make_sharded_infer(apply_fn: Callable, mesh, *, axis: int = 1) -> Callable:
    """One frame sharded across cards with halo exchanges: not ported yet."""
    raise NotImplementedError(_MULTI_GPU)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"mesh: {_MULTI_GPU}")


def make_flow_aware_tiled(apply_fn: Callable, params, tile: int, *,
                          train_apply_fn: Optional[Callable] = None,
                          default_flow_px: float = 32.0, tile_batch: int = 8, mesh=None,
                          verbose: bool = True, unsafe_plan: str = "full") -> Callable:
    """``infer(x0, x1, t) -> pred`` with a per-pair, flow-sized tile overlap.

    Frames no larger than ``tile``, and batches of more than one pair, run
    full-frame. A larger single pair is probed (:func:`make_flow_probe`
    over ``train_apply_fn``, or ``default_flow_px`` without one) and tiled
    with :func:`required_overlap`'s plan (:func:`_plan_tiles`). Failure
    modes are loud: a probe that raises TypeError/KeyError warns and falls
    back to ``default_flow_px``; when the plan's overlap exceeds
    ``tile // 2``, ``unsafe_plan="full"`` runs the pair full-frame with a
    warning and ``"raise"`` raises ValueError."""
    if unsafe_plan not in ("full", "raise"):
        raise ValueError(f"unsafe_plan must be 'full' or 'raise', got {unsafe_plan!r}")
    _no_mesh(mesh)
    cache: dict = {}
    probe = make_flow_probe(train_apply_fn) if train_apply_fn else None

    def infer(x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        H, W = x0.shape[1:3]
        if max(H, W) <= tile or x0.shape[0] != 1:
            return apply_fn(params, x0, x1, t)
        plan = _plan_tiles(probe, params, x0, x1, t, tile, default_flow_px=default_flow_px,
                           unsafe_plan=unsafe_plan)
        if plan is None:
            return apply_fn(params, x0, x1, t)
        if plan not in cache:
            overlap, trim = plan
            if verbose:
                print(f"tiling plan: tile {tile}, overlap {overlap}, trim {trim}")
            cache[plan] = make_tiled_infer(apply_fn, tile_hw=(tile, tile), overlap=overlap,
                                           trim=trim, tile_batch=tile_batch)
        return cache[plan](params, x0, x1, t)

    infer.plans = cache
    return infer


def _plan_tiles(probe: Optional[Callable], params, x0: torch.Tensor, x1: torch.Tensor,
                t: torch.Tensor, tile: int, *, default_flow_px: float, unsafe_plan: str,
                mag_scale: float = 1.0) -> Optional[tuple[int, int]]:
    """A seam-safe ``(overlap, trim)`` for one pair, or None for full-frame.

    ``mag_scale`` inflates the probed t = 0.5 magnitude; the multi-instant
    path uses it, since instants near 0 or 1 sample up to the whole pair's
    motion."""
    mag = default_flow_px
    if probe is not None:
        try:
            mag = probe(params, x0, x1, t)
        except (TypeError, KeyError) as e:
            warnings.warn(
                f"flow probe unavailable ({type(e).__name__}: {e}); "
                f"falling back to default_flow_px={default_flow_px} — "
                f"motion beyond that may seam", stacklevel=3)
    mag = mag * mag_scale
    overlap, trim = required_overlap(mag)
    if overlap > tile // 2:
        if unsafe_plan == "raise":
            raise ValueError(
                f"estimated motion {mag:.0f}px needs overlap {overlap} "
                f"> tile/2 ({tile // 2}); use a larger --tile, or "
                f"halo sharding (make_sharded_infer) which has no "
                f"overlap assumption")
        warnings.warn(
            f"estimated motion {mag:.0f}px needs overlap {overlap} > "
            f"tile/2 ({tile // 2}); running FULL-FRAME for this pair "
            f"(seam-free; if it OOMs, use make_sharded_infer)",
            stacklevel=3)
        return None
    check_overlap(overlap, trim, mag, tile)
    return overlap, trim


def make_flow_aware_multi_t(multi_apply_fn: Callable, params, tile: int, ts: tuple, *,
                            train_apply_fn: Optional[Callable] = None,
                            default_flow_px: float = 32.0, tile_batch: int = 8, mesh=None,
                            verbose: bool = True, unsafe_plan: str = "full") -> Callable:
    """``infer(x0, x1) -> (T, 1, H, W, 3)``: every instant of ``ts`` per
    pair, tiled as :func:`make_flow_aware_tiled` tiles, the encoder run once
    per tile (``multi_apply_fn(params, x0, x1) -> (T, B, H, W, 3)``). The
    probe runs at t = 0.5, whose flows read about half the pair's motion,
    so the plan inflates the estimate by ``2 * max(max(ts), 1 - min(ts))``."""
    if unsafe_plan not in ("full", "raise"):
        raise ValueError(f"unsafe_plan must be 'full' or 'raise', got {unsafe_plan!r}")
    _no_mesh(mesh)
    cache: dict = {}
    probe = make_flow_probe(train_apply_fn) if train_apply_fn else None
    mag_scale = 2.0 * max(max(ts), 1.0 - min(ts)) if ts else 1.0

    def infer(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        H, W = x0.shape[1:3]
        if max(H, W) <= tile or x0.shape[0] != 1:
            return multi_apply_fn(params, x0, x1)
        t05 = torch.full((x0.shape[0], 1, 1, 1), 0.5, dtype=torch.float32, device=x0.device)
        plan = _plan_tiles(probe, params, x0, x1, t05, tile, default_flow_px=default_flow_px,
                           unsafe_plan=unsafe_plan, mag_scale=mag_scale)
        if plan is None:
            return multi_apply_fn(params, x0, x1)
        if plan not in cache:
            overlap, trim = plan
            if verbose:
                print(f"tiling plan (multi-t x{len(ts)}): tile {tile}, "
                      f"overlap {overlap}, trim {trim}")
            cache[plan] = make_tiled_multi_t(multi_apply_fn, tile_hw=(tile, tile),
                                             overlap=overlap, trim=trim, tile_batch=tile_batch)
        return cache[plan](params, x0, x1)

    infer.plans = cache
    return infer


def _tile_starts(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) with the final tile right-aligned."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def _feather_1d(size: int, overlap: int, trim: int, lo_interior: bool,
                hi_interior: bool) -> np.ndarray:
    """Per-axis blend profile: full weight at the frame's border; at a cut
    edge ``trim`` zeroed pixels, then a raised-cosine ramp across the rest
    of the overlap."""
    w = np.ones(size, np.float32)
    ramp_len = max(overlap - trim, 1)
    ramp = 0.5 - 0.5 * np.cos(
        np.pi * (np.arange(ramp_len, dtype=np.float32) + 0.5) / ramp_len)
    if lo_interior:
        w[:trim] = 0.0
        w[trim:trim + ramp_len] = ramp
    if hi_interior:
        w[size - trim:] = 0.0
        w[size - trim - ramp_len:size - trim] = ramp[::-1]
    return w


def _grid(H: int, W: int, tile_hw: tuple[int, int], overlap: int):
    th, tw = tile_hw
    th, tw = min(th, H), min(tw, W)
    ys = _tile_starts(H, th, th - overlap)
    xs = _tile_starts(W, tw, tw - overlap)
    return th, tw, [(y, x) for y in ys for x in xs]


def _blend_weights(coords, th, tw, H, W, overlap, trim=None):
    """Per-tile feather masks ``(n, th, tw, 1)``. ``trim`` defaults to
    overlap // 4 and is clamped to overlap // 2, so that every pixel keeps
    some weight."""
    ov = min(overlap, th // 2, tw // 2)
    trim = ov // 4 if trim is None else max(0, min(trim, ov // 2))
    out = []
    for (y, x) in coords:
        wy = _feather_1d(th, ov, trim, lo_interior=y > 0, hi_interior=y + th < H)
        wx = _feather_1d(tw, ov, trim, lo_interior=x > 0, hi_interior=x + tw < W)
        out.append(wy[:, None] * wx[None, :])
    return np.stack(out)[..., None]


def _tiles(x0: torch.Tensor, x1: torch.Tensor, tile_hw, overlap: int, tile_batch: int):
    """The tiles of one pair in the JAX order, padded by wrap-around to a
    multiple of ``tile_batch``: ``(th, tw, coords, tiles0, tiles1)``."""
    B, H, W, C = x0.shape
    assert B == 1, "tile over one frame pair at a time"
    th, tw, coords = _grid(H, W, tile_hw, overlap)
    n = len(coords)
    tiles0 = torch.stack([x0[0, y:y + th, x:x + tw] for (y, x) in coords])
    tiles1 = torch.stack([x1[0, y:y + th, x:x + tw] for (y, x) in coords])
    n_pad = math.ceil(n / tile_batch) * tile_batch - n
    if n_pad:
        pad_idx = torch.from_numpy(np.arange(n_pad) % n).to(x0.device)   # wraps when n < n_pad
        tiles0 = torch.cat([tiles0, tiles0[pad_idx]])
        tiles1 = torch.cat([tiles1, tiles1[pad_idx]])
    return th, tw, coords, tiles0, tiles1


def _blend(preds: torch.Tensor, coords, th: int, tw: int, H: int, W: int, overlap: int,
           trim: Optional[int]) -> torch.Tensor:
    """Feather-blend ``preds (T, n, th, tw, C)`` into ``(T, H, W, C)``, tile
    by tile in order, in the predictions' dtype."""
    T, _, _, _, C = preds.shape
    weights = torch.from_numpy(_blend_weights(coords, th, tw, H, W, overlap, trim)).to(preds)
    acc = preds.new_zeros((T, H, W, C))
    norm = preds.new_zeros((H, W, 1))
    for k, (y, x) in enumerate(coords):
        acc[:, y:y + th, x:x + tw] += preds[:, k] * weights[k]
        norm[y:y + th, x:x + tw] += weights[k]
    return acc / norm


def make_tiled_infer(apply_fn: Callable, *, tile_hw: tuple[int, int] = (256, 256),
                     overlap: int = 64, trim: Optional[int] = None, tile_batch: int = 8,
                     mesh=None) -> Callable:
    """``tiled(params, x0, x1, t) -> (1, H, W, 3)``: the pair's tiles in
    chunks of ``tile_batch`` through ``apply_fn(params, a, b, t)``, the
    last chunk padded by wrap-around, then feather-blended."""
    _no_mesh(mesh)

    def tiled(params, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        H, W = x0.shape[1:3]
        th, tw, coords, tiles0, tiles1 = _tiles(x0, x1, tile_hw, overlap, tile_batch)
        tb = t.expand(tile_batch, 1, 1, 1).contiguous()
        preds = torch.cat([apply_fn(params, tiles0[i:i + tile_batch], tiles1[i:i + tile_batch],
                                    tb) for i in range(0, len(tiles0), tile_batch)])
        return _blend(preds[None, :len(coords)], coords, th, tw, H, W, overlap, trim)

    return tiled


def make_tiled_multi_t(multi_apply_fn: Callable, *, tile_hw: tuple[int, int] = (256, 256),
                       overlap: int = 64, trim: Optional[int] = None, tile_batch: int = 8,
                       mesh=None) -> Callable:
    """``tiled(params, x0, x1) -> (T, 1, H, W, 3)``: as
    :func:`make_tiled_infer`, every instant of a tile decoded from one
    encoder run (``multi_apply_fn(params, a, b) -> (T, B, h, w, 3)``)."""
    _no_mesh(mesh)

    def tiled(params, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        H, W = x0.shape[1:3]
        th, tw, coords, tiles0, tiles1 = _tiles(x0, x1, tile_hw, overlap, tile_batch)
        preds = torch.cat([multi_apply_fn(params, tiles0[i:i + tile_batch],
                                          tiles1[i:i + tile_batch])
                           for i in range(0, len(tiles0), tile_batch)], dim=1)
        return _blend(preds[:, :len(coords)], coords, th, tw, H, W, overlap, trim)[:, None]

    return tiled


def tiled_inference(infer: Callable, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor, *,
                    tile_hw: tuple[int, int] = (256, 256), overlap: int = 64,
                    trim: Optional[int] = None, tile_batch: int = 8) -> torch.Tensor:
    """``(1, H, W, 3)``: ``infer(a, b, t)`` over overlapping tiles in chunks
    of ``tile_batch``, feather-blended: :func:`make_tiled_infer` over ``infer``."""
    tiled = make_tiled_infer(lambda _, a, b, tt: infer(a, b, tt), tile_hw=tile_hw,
                             overlap=overlap, trim=trim, tile_batch=tile_batch)
    return tiled(None, x0, x1, t)
