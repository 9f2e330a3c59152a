"""The DAT levels' deformable sampler on the card, at the level shapes the port's paths launch.

    python -m videoframeinterpolation_tpu_torch.tools.perf.sampler_probe

Times :func:`...kernels.window_sample.deformable_sample` at the three levels
of each served configuration: the shared-offset student
(``configs/DAT_fast.yaml``: G 1, S 8/8/2), the non-shared flagship
(``configs/DAT.yaml``: G 4/8/8, S 8/16/32) and the distillation teacher
(G 1, S 8/16/8), each at a 448x256 request (B2 2: both frames of one
pair) and at a held-out evaluation batch (8 pairs of 128x128, B2 16), with
C 72 (nf 72), in bf16 and fp32. Per level it prints the kernel's time on
the device's clock (calls captured in a CUDA graph, marginal over 16
calls), its time issued from Python, the plain version's,
``F.grid_sample``'s on the same work (device clock, inputs arranged
beforehand), the bound (bytes: each input read once, the output written
once, over 3.35 TB/s; operations: 4 multiplies and 3 adds per output
element at the fp32 rate) and the kernel's share of it. Needs a CUDA
device, and raises without one. Timing launches are not counted in
``deformable_sample.launches``.
"""

from __future__ import annotations

import json
from typing import Callable

import torch
import torch.nn.functional as F

from ...kernels.window_sample import deformable_sample, deformable_sample_plain
from .timing import bytes_bound_ms, device_marginal_ms, loop_ms, require_card

FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
C = 72
# name -> (G, S) per level lv3, lv2, lv1, and each level's offset scale.
CONFIG_LEVELS = {"shared": ((1, 8), (1, 8), (1, 2)),
                 "non_shared": ((4, 8), (8, 16), (8, 32)),
                 "teacher": ((1, 8), (1, 16), (1, 8))}
SCALES = (2.0, 4.0, 8.0)


def _levels(B2: int, H: int, W: int, gs) -> tuple:
    """``(name, B2, h, w, G, S, offset_scale)`` of the three DAT levels of an
    ``H x W`` input (1/8, 1/4 and 1/2 of it)."""
    return tuple((f"lv{3 - i}", B2, H // d, W // d, G, S, SCALES[i])
                 for i, ((G, S), d) in enumerate(zip(gs, (8, 4, 2))))


# A 448x256 request (B2 2) and a held-out evaluation batch (8 pairs of
# 128x128, B2 16) of each configuration.
LEVEL_SETS = {**{kind: _levels(2, 256, 448, gs) for kind, gs in CONFIG_LEVELS.items()},
              **{f"eval_{kind}": _levels(16, 128, 128, gs)
                 for kind, gs in CONFIG_LEVELS.items()}}


def level_inputs(gen: torch.Generator, B2: int, h: int, w: int, C: int, G: int, S: int,
                 scale: float, flow_mag: float = 4.0):
    """fp32 ``feat``, ``flow`` and ``residual`` (``scale * tanh``, as the model
    bounds it) on the card."""
    feat = torch.randn((B2, h, w, C), generator=gen, device="cuda")
    flow = torch.randn((B2, h, w, 2), generator=gen, device="cuda") * flow_mag
    res = scale * torch.tanh(torch.randn((B2, h, w, G, S, 2), generator=gen, device="cuda"))
    return feat, flow, res


def level_times(feat: torch.Tensor, flow: torch.Tensor, res: torch.Tensor,
                kernel: Callable = deformable_sample,
                plain: Callable = deformable_sample_plain) -> dict:
    """One level: kernel, plain version, bound and ``F.grid_sample`` on the
    same work. The kernel's and F.grid_sample's times are on the device's
    clock; ``host_ms`` is the kernel issued from Python."""
    B2, h, w, C = feat.shape
    G, S = res.shape[3], res.shape[4]
    calls, calls_bf16 = kernel.launches, kernel.bf16_launches
    ms = device_marginal_ms(lambda: kernel(feat, flow, res, G), n_hi=17)
    host_ms = loop_ms(lambda: kernel(feat, flow, res, G), 50) / 50
    kernel.launches, kernel.bf16_launches = calls, calls_bf16
    plain_ms = loop_ms(lambda: plain(feat, flow, res, G), 10) / 10

    # Library yardstick: NCHW input and a normalized (align_corners) grid.
    gy, gx = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([gx, gy], -1)[None, :, :, None, None] + (res + flow[:, :, :, None, None])
    coords = coords.permute(0, 3, 4, 1, 2, 5).reshape(B2 * G, S * h, w, 2)
    grid = torch.stack([coords[..., 0] * (2.0 / (w - 1)) - 1.0,
                        coords[..., 1] * (2.0 / (h - 1)) - 1.0], -1).to(feat.dtype).contiguous()
    inp = feat.reshape(B2, h, w, G, C // G).permute(0, 3, 4, 1, 2).reshape(
        B2 * G, C // G, h, w).contiguous()
    library_ms = device_marginal_ms(lambda: F.grid_sample(inp, grid, mode="bilinear",
                                                          padding_mode="zeros",
                                                          align_corners=True), n_hi=17)

    nbytes = feat.element_size() * (B2 * S * h * w * C + feat.numel() + flow.numel()
                                    + res.numel())
    bytes_ms = bytes_bound_ms(nbytes)
    ops_ms = 7 * B2 * S * h * w * C / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": [B2, h, w, C, G, S], "dtype": str(feat.dtype).removeprefix("torch."),
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes,
            "share_of_bound": bound_ms / ms, "library_over_kernel": library_ms / ms}


def main() -> dict:
    """``{"shared" | "non_shared": {"bfloat16" | "float32": {level: row}}}``."""
    card = require_card()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows: dict = {}
    for kind, levels in LEVEL_SETS.items():
        for name, B2, h, w, G, S, scale in levels:
            fp32 = level_inputs(gen, B2, h, w, C, G, S, scale)
            for dtype in (torch.bfloat16, torch.float32):
                row = level_times(*(x.to(dtype) for x in fp32))
                rows.setdefault(kind, {}).setdefault(row["dtype"], {})[name] = row
                print(json.dumps({"levels": kind, "level": name, **row, "card": card}),
                      flush=True)
            del fp32
    return rows


if __name__ == "__main__":
    main()
