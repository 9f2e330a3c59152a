"""The DAT levels' deformable sampler on the card, at the level shapes the port's paths launch.

    python -m videoframeinterpolation_tpu_torch.tools.perf.sampler_probe \
        [--backward [--train_levels student|dcndat]] [--stride 2]

Times :func:`...kernels.window_sample.deformable_sample` at the three levels
of each served configuration: the shared-offset student
(``configs/DAT_fast.yaml``: G 1, S 8/8/2), the non-shared flagship
(``configs/DAT.yaml``: G 4/8/8, S 8/16/32) and the distillation teacher
(G 1, S 8/16/8), each at a 448x256 request (B2 2: both frames of one
pair) and at a held-out evaluation batch (8 pairs of 128x128, B2 16), with
C 72 (nf 72); and DCNDAT (``configs/archive/DCNDAT.yaml``: C 64, G 8/4/4,
S 9) at a 448x256 request and a validation batch (4 pairs of 256x448, B2
8); in bf16 and fp32. Per level it prints the kernel's time on
the device's clock (calls captured in a CUDA graph, marginal over 16
calls), its time issued from Python, the plain version's,
``F.grid_sample``'s on the same work (device clock, inputs arranged
beforehand), the bound (bytes: each input read once, the output written
once, over 3.35 TB/s; operations: 4 multiplies and 3 adds per output
element at the fp32 rate) and the kernel's share of it. Needs a CUDA
device, and raises without one. Timing launches are not counted in
``deformable_sample``'s launch counts.

With ``--backward`` it times the backward (``_launch_backward``, the
whole call: its kernels and whatever buffers and casts its path needs) at
the student's three levels of a training batch (``TRAIN_LEVELS``: 8 pairs
of 128x128, B2 16, S 8/8/2), or with ``--train_levels dcndat`` at DCNDAT's
(its recipe's 12 pairs of 256x256, B2 24, C 64, G 8/4/4, S 9), on the
path ``_backward_plan`` picks and on the global path forced, beside autograd through the plain version,
``F.grid_sample``'s backward on the same work (``aten::grid_sampler_2d_backward``,
both gradients) and the bound: bytes, each input (feat, flow, residual,
grad_out) read once and each gradient written once in the inputs' dtype;
operations, 22 per sample and channel (14 for the coordinate gradient, 4
products and 4 adds into the taps) at the fp32 rate. It prints each
level's plan (path, channels per block, shared-memory bytes), the device
operations one call issues on each path (``torch.profiler``), and the
registers and spills ``ptxas`` reported for the backward kernels. To
compare with an earlier tree on the same card, run this from each tree's
root in one command, earlier / this / this / earlier.

With ``--stride 2`` both run instead on the query grid of stride 2 of the
``attn_stride`` variant's level 1 (``STRIDED_LEVELS``: shared offsets, S
16, a 448x256 request and an evaluation batch forward, a training batch
backward): the features at full resolution, the flow, residual and output
on the grid twice as coarse, ``F.grid_sample`` (and its backward) on the
same coordinates, and the same bounds (the output, residual and flow on
the coarse grid, one read of the full-resolution features).
"""

from __future__ import annotations

import json
from typing import Callable

import torch
import torch.nn.functional as F

from ...kernels import build
from ...ops.warp import base_grid
from ...kernels.window_sample import (BackwardPlan, _backward_plan, _launch_backward,
                                      deformable_sample, deformable_sample_backward_plain,
                                      deformable_sample_plain)
from .timing import bytes_bound_ms, device_marginal_ms, device_ops, loop_ms, require_card

FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
C = 72
# name -> (G, S) per level lv3, lv2, lv1, and each level's offset scale.
CONFIG_LEVELS = {"shared": ((1, 8), (1, 8), (1, 2)),
                 "non_shared": ((4, 8), (8, 16), (8, 32)),
                 "teacher": ((1, 8), (1, 16), (1, 8))}
SCALES = (2.0, 4.0, 8.0)
# DCNDAT (configs/archive/DCNDAT.yaml): nf 64, non-shared offsets, G 8/4/4,
# S 9 and offset scale 2 at every level.
DCNDAT_C = 64
DCNDAT_LEVELS = ((8, 9), (4, 9), (4, 9))
DCNDAT_SCALES = (2.0, 2.0, 2.0)


def _levels(B2: int, H: int, W: int, gs, scales=SCALES) -> tuple:
    """``(name, B2, h, w, G, S, offset_scale)`` of the three DAT levels of an
    ``H x W`` input (1/8, 1/4 and 1/2 of it)."""
    return tuple((f"lv{3 - i}", B2, H // d, W // d, G, S, scales[i])
                 for i, ((G, S), d) in enumerate(zip(gs, (8, 4, 2))))


# A 448x256 request (B2 2) and a held-out evaluation batch (8 pairs of
# 128x128, B2 16) of each configuration, and DCNDAT's 448x256 request and
# validation batch (4 pairs of 256x448, B2 8).
LEVEL_SETS = {**{kind: _levels(2, 256, 448, gs) for kind, gs in CONFIG_LEVELS.items()},
              **{f"eval_{kind}": _levels(16, 128, 128, gs)
                 for kind, gs in CONFIG_LEVELS.items()},
              "dcndat": _levels(2, 256, 448, DCNDAT_LEVELS, DCNDAT_SCALES),
              "eval4_dcndat": _levels(8, 256, 448, DCNDAT_LEVELS, DCNDAT_SCALES)}
# The channels of each level set (C unless named here).
LEVEL_CHANNELS = {"dcndat": DCNDAT_C, "eval4_dcndat": DCNDAT_C}


# The student's levels of a training batch (8 pairs of 128x128, B2 16), and
# DCNDAT's at its recipe (12 pairs of 256x256, B2 24), each with its channels.
TRAIN_LEVELS = _levels(16, 128, 128, CONFIG_LEVELS["shared"])
TRAIN_LEVEL_SETS = {"student": (TRAIN_LEVELS, C),
                    "dcndat": (_levels(24, 256, 256, DCNDAT_LEVELS, DCNDAT_SCALES), DCNDAT_C)}

# The attn_stride variant's level 1 (the quality study's stride arm: shared
# offsets, S 16, the query grid of stride 2 over the 1/2-scale features),
# name -> (name, B2, H, W, G, S, offset scale) with (H, W) the feature grid:
# a 448x256 request and an evaluation batch (8 pairs of 128x128) forward,
# and the training batch's backward.
STRIDE = 2
STRIDED_LEVELS = {"stride_arm": (("lv1", 2, 128, 224, 1, 16, 8.0),),
                  "eval_stride_arm": (("lv1", 16, 64, 64, 1, 16, 8.0),)}
STRIDED_TRAIN_LEVELS = (("lv1", 16, 64, 64, 1, 16, 8.0),)


def level_inputs(gen: torch.Generator, B2: int, h: int, w: int, C: int, G: int, S: int,
                 scale: float, flow_mag: float = 4.0, stride: int = 1):
    """fp32 ``feat`` (``h x w``), and ``flow`` and ``residual`` (``scale *
    tanh``, as the model bounds it) on the query grid of ``stride``, on the
    card."""
    feat = torch.randn((B2, h, w, C), generator=gen, device="cuda")
    qh, qw = h // stride, w // stride
    flow = torch.randn((B2, qh, qw, 2), generator=gen, device="cuda") * flow_mag
    res = scale * torch.tanh(torch.randn((B2, qh, qw, G, S, 2), generator=gen, device="cuda"))
    return feat, flow, res


def _library_inputs(feat: torch.Tensor, flow: torch.Tensor, res: torch.Tensor, stride: int):
    """``F.grid_sample``'s NCHW input and normalized (align_corners) grid of
    the same work: one image per (frame, group), its S samples of the query
    grid stacked along the grid's rows."""
    B2, H, W, C = feat.shape
    G, S = res.shape[3], res.shape[4]
    h, w = flow.shape[1:3]
    coords = (base_grid(h, w, "cuda", stride)[None, :, :, None, None]
              + (res.float() + flow.float()[:, :, :, None, None]))
    coords = coords.permute(0, 3, 4, 1, 2, 5).reshape(B2 * G, S * h, w, 2)
    grid = torch.stack([coords[..., 0] * (2.0 / (W - 1)) - 1.0,
                        coords[..., 1] * (2.0 / (H - 1)) - 1.0], -1).to(feat.dtype).contiguous()
    inp = feat.reshape(B2, H, W, G, C // G).permute(0, 3, 4, 1, 2).reshape(
        B2 * G, C // G, H, W).contiguous()
    return inp, grid


def level_times(feat: torch.Tensor, flow: torch.Tensor, res: torch.Tensor,
                kernel: Callable = deformable_sample,
                plain: Callable = deformable_sample_plain, stride: int = 1) -> dict:
    """One level: kernel, plain version, bound and ``F.grid_sample`` on the
    same work. The kernel's and F.grid_sample's times are on the device's
    clock; ``host_ms`` is the kernel issued from Python."""
    B2, H, W, C = feat.shape
    G, S = res.shape[3], res.shape[4]
    queries = B2 * flow.shape[1] * flow.shape[2]
    calls = (kernel.launches, kernel.bf16_launches, kernel.strided_launches)
    ms = device_marginal_ms(lambda: kernel(feat, flow, res, G, stride=stride), n_hi=17)
    host_ms = loop_ms(lambda: kernel(feat, flow, res, G, stride=stride), 50) / 50
    kernel.launches, kernel.bf16_launches, kernel.strided_launches = calls
    plain_ms = loop_ms(lambda: plain(feat, flow, res, G, stride), 10) / 10

    inp, grid = _library_inputs(feat, flow, res, stride)
    library_ms = device_marginal_ms(lambda: F.grid_sample(inp, grid, mode="bilinear",
                                                          padding_mode="zeros",
                                                          align_corners=True), n_hi=17)

    nbytes = feat.element_size() * (queries * S * C + feat.numel() + flow.numel()
                                    + res.numel())
    bytes_ms = bytes_bound_ms(nbytes)
    ops_ms = 7 * queries * S * C / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": [B2, H, W, C, G, S], "stride": stride,
            "dtype": str(feat.dtype).removeprefix("torch."),
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes,
            "share_of_bound": bound_ms / ms, "library_over_kernel": library_ms / ms}


def backward_level_times(feat: torch.Tensor, flow: torch.Tensor, res: torch.Tensor,
                         grad_out: torch.Tensor, stride: int = 1) -> dict:
    """One level's backward: the planned path and the global path (device
    clock, and the device operations of one call), autograd through the
    plain version, ``F.grid_sample``'s backward on the same work (device
    clock) and the bound."""
    B2, H, W, C = feat.shape
    G, S = res.shape[3], res.shape[4]
    h, w = flow.shape[1:3]
    plan = _backward_plan(B2, H, W, C, G, S, stride)
    calls = (deformable_sample.backward_launches,
             dict(deformable_sample.backward_path_launches),
             deformable_sample.strided_backward_launches)
    paths = {}
    for name, p in (("planned", plan), ("global", BackwardPlan("global", 0, 0, plan.index_bits))):
        def run(p=p):
            return _launch_backward(feat, flow, res, grad_out, G, plan=p, stride=stride)

        paths[name] = {"ms": device_marginal_ms(run, n_hi=17), "device_ops": device_ops(run)}
    deformable_sample.backward_launches = calls[0]
    deformable_sample.backward_path_launches.update(calls[1])
    deformable_sample.strided_backward_launches = calls[2]
    ms = paths["planned"]["ms"]
    plain_ms = loop_ms(lambda: deformable_sample_backward_plain(feat, flow, res, grad_out, G,
                                                                stride), 10) / 10

    inp, grid = _library_inputs(feat, flow, res, stride)
    gout = grad_out.reshape(B2, S, h, w, G, C // G).permute(0, 4, 5, 1, 2, 3).reshape(
        B2 * G, C // G, S * h, w).contiguous()
    library_ms = device_marginal_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, inp, grid, 0, 0, True, [True, True]), n_hi=17)

    nbytes = feat.element_size() * 2 * (feat.numel() + flow.numel() + res.numel()) \
        + grad_out.element_size() * grad_out.numel()
    bytes_ms = bytes_bound_ms(nbytes)
    ops_ms = 22 * B2 * S * h * w * C / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": [B2, H, W, C, G, S], "stride": stride,
            "dtype": str(feat.dtype).removeprefix("torch."),
            "plan": plan._asdict(), "ms": ms, "global_ms": paths["global"]["ms"],
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes,
            "share_of_bound": bound_ms / ms, "library_over_kernel": library_ms / ms,
            "global_over_planned": paths["global"]["ms"] / ms,
            "device_ops": {k: v["device_ops"] for k, v in paths.items()}}


def main_backward(stride: int = 1, levels: str = "student") -> dict:
    """``{"bfloat16" | "float32": {level: row}}`` of the backward kernel at
    ``TRAIN_LEVEL_SETS[levels]`` (the student's by default), or at
    ``STRIDED_TRAIN_LEVELS`` with ``stride``."""
    card = require_card()
    print(card, flush=True)
    build.load_library()
    for row in build.ptxas_report():
        if "bwd" in row["function"]:
            print(json.dumps({"ptxas": row}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows: dict = {}
    train_levels, channels = (TRAIN_LEVEL_SETS[levels] if stride == 1
                              else (STRIDED_TRAIN_LEVELS, C))
    for name, B2, h, w, G, S, scale in train_levels:
        fp32 = level_inputs(gen, B2, h, w, channels, G, S, scale, stride=stride)
        grad_out = torch.randn((B2, S, h * w // stride ** 2, channels), generator=gen,
                               device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            row = backward_level_times(*(x.to(dtype) for x in (*fp32, grad_out)), stride=stride)
            rows.setdefault(row["dtype"], {})[name] = row
            print(json.dumps({"backward_level": name, **row, "card": card}), flush=True)
        del fp32, grad_out
    return rows


def main(stride: int = 1) -> dict:
    """``{level set: {"bfloat16" | "float32": {level: row}}}`` at
    ``LEVEL_SETS``, or at ``STRIDED_LEVELS`` with ``stride``."""
    card = require_card()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows: dict = {}
    for kind, levels in (LEVEL_SETS if stride == 1 else STRIDED_LEVELS).items():
        for name, B2, h, w, G, S, scale in levels:
            fp32 = level_inputs(gen, B2, h, w, LEVEL_CHANNELS.get(kind, C), G, S, scale,
                                stride=stride)
            for dtype in (torch.bfloat16, torch.float32):
                row = level_times(*(x.to(dtype) for x in fp32), stride=stride)
                rows.setdefault(kind, {}).setdefault(row["dtype"], {})[name] = row
                print(json.dumps({"levels": kind, "level": name, **row, "card": card}),
                      flush=True)
            del fp32
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--stride", type=int, choices=(1, STRIDE), default=1)
    ap.add_argument("--train_levels", choices=sorted(TRAIN_LEVEL_SETS), default="student",
                    help="with --backward: the student's training levels or DCNDAT's")
    args = ap.parse_args()
    if args.backward:
        main_backward(args.stride, args.train_levels)
    else:
        main(args.stride)
