"""Softmax-splatting forward warp (counterpart of ``videoframeinterpolation_tpu/ops/softsplat.py``).

Each source pixel ``(x, y)`` adds its value into the four corner taps of
``(x + fx, y + fy)`` with bilinear weights; a tap whose corner lies
outside the frame is dropped (it lands in a trash slot at ``H * W``).
Target positions are taken in fp32 whatever the compute dtype, the
weights in the compute dtype.

The sum is an accumulating ``index_put_``, one per corner. On the card
it sorts the targets (a stable sort) and sums each target's updates in
fp32 in that order, rounding once, so two identical calls give the same
bits (an ``index_add_`` there sums with atomics, in an order that changes
from run to run; XLA's scatter is deterministic too). On the CPU it adds
bf16 updates one at a time in index order, rounding every add, as XLA's
CPU scatter-add does (bit for bit), and fp32 ones likewise on one thread
but with atomic adds in parallel on several (their order, and the last
bit, then change from run to run). No hand-written kernel: the JAX
package computes the splat in XLA, not in Pallas. The gradient is
autograd's: a gather for ``x``, the weights' derivatives summed over
channels for ``flow`` (``floor`` has none), JAX's VJP of the same
expression.
"""

from __future__ import annotations

import torch


def weak_constant(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as JAX's weakly typed constant in an operation on ``like``:
    rounded to ``like``'s dtype (in bf16, 1e-7 is 1.0012e-7)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def softsplat_raw(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-add of ``x (B, H, W, C)`` along ``flow (B, H, W, 2)``
    (``(fx, fy)`` pixels): ``(B, H, W, C)``, zeros where nothing lands."""
    B, H, W, C = x.shape
    dtype = x.dtype
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                            torch.arange(W, dtype=torch.float32, device=x.device),
                            indexing="ij")
    tx = gx + flow[..., 0].float()
    ty = gy + flow[..., 1].float()
    x0f, y0f = torch.floor(tx), torch.floor(ty)
    wx = (tx - x0f).to(dtype)
    wy = (ty - y0f).to(dtype)
    # Clamped before the integer cast so that a far tap cannot overflow;
    # the range keeps every in-bounds decision unchanged.
    x0 = x0f.clamp(-2, W + 1).long()
    y0 = y0f.clamp(-2, H + 1).long()
    x1, y1 = x0 + 1, y0 + 1

    trash = H * W
    out = x.new_zeros((B, H * W + 1, C))
    xf = x.reshape(B, H * W, C)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, H * W)
    for xi, yi, w in ((x0, y0, (1.0 - wx) * (1.0 - wy)), (x1, y0, wx * (1.0 - wy)),
                      (x0, y1, (1.0 - wx) * wy), (x1, y1, wx * wy)):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = torch.where(valid, yi * W + xi.clamp(0, W - 1), trash).reshape(B, H * W)
        out.index_put_((bidx, idx), xf * w.reshape(B, H * W, 1), accumulate=True)
    return out[:, :H * W].reshape(B, H, W, C)


def softsplat(x: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None = None,
              mode: str = "soft") -> torch.Tensor:
    """Forward warping of ``x (B, H, W, C)`` along ``flow (B, H, W, 2)``:
    ``mode`` ``'sum' | 'avg' | 'linear' | 'soft'`` (``metric (B, H, W, 1)``
    for the last two), optionally suffixed ``-addeps`` (default),
    ``-zeroeps`` or ``-clipeps`` for the normaliser, with JAX's
    ``ValueError``s."""
    base = mode.split("-")[0]
    if base not in ("sum", "avg", "linear", "soft"):
        raise ValueError(f"unsupported mode: {mode}")
    if base in ("sum", "avg") and metric is not None:
        raise ValueError(f"mode {mode} takes no metric")
    if base in ("linear", "soft") and metric is None:
        raise ValueError(f"mode {mode} requires a metric")

    if base == "sum":
        return softsplat_raw(x, flow)
    if base == "avg":
        inp = torch.cat([x, x.new_ones(x.shape[:3] + (1,))], dim=-1)
    elif base == "linear":
        inp = torch.cat([x * metric, metric], dim=-1)
    else:
        m = torch.exp(metric)
        inp = torch.cat([x * m, m], dim=-1)

    out = softsplat_raw(inp, flow)
    norm = out[..., -1:]
    parts = mode.split("-")
    variant = parts[1] if len(parts) > 1 else "addeps"
    eps = weak_constant(1e-7, norm)
    if variant == "addeps":
        norm = norm + eps
    elif variant == "zeroeps":
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    elif variant == "clipeps":
        norm = torch.maximum(norm, eps)
    else:
        raise ValueError(f"unsupported eps variant: {mode}")
    return out[..., :-1] / norm
