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


def multi_t_apply(model, x0: torch.Tensor, x1: torch.Tensor, ts) -> torch.Tensor:
    """All intermediate frames of one pair, the encoder run once.

    Counterpart of ``videoframeinterpolation_tpu/models/base.py:multi_t_apply``:
    for a model with the staged ``encode``/``decode`` API (the DAT family,
    ``models/dat.py:CoarseToFineDAT``, and GMTrans; IFRNet has none and
    raises), the t-invariant encoder pyramid runs once and ``decode`` runs
    per instant, so factor-N upsampling pays one encoder per pair instead
    of one per output frame. Each frame equals
    ``model(x0, x1, t)``: the same operations on the same inputs.

    Args:
      model: a module with ``encode``/``decode`` methods.
      x0, x1: ``(B, H, W, 3)``.
      ts: a non-empty sequence of Python floats in (0, 1).

    Returns:
      ``(len(ts), B, H, W, 3)`` predictions.
    """
    if not ts:
        raise ValueError("multi_t_apply needs at least one instant")
    if not hasattr(model, "decode"):
        raise ValueError(f"{type(model).__name__} has no staged encode/decode: serve its "
                         "instants one forward each (--mode recursive)")
    feats, mean = model.encode(x0, x1)
    B = x0.shape[0]
    return torch.stack([
        model.decode(feats, mean, torch.full((B, 1, 1, 1), t, dtype=torch.float32,
                                             device=x0.device))
        for t in ts])
