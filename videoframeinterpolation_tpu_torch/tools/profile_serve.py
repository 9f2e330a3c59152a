"""Where a 448x256 request's time goes on the card: a torch.profiler trace.

    python -m videoframeinterpolation_tpu_torch.tools.profile_serve \
        [--config DAT_fast|configs/IFRNet.yaml --ckpt c.ckpt] [--out profile_serve.json]

Serves a model through ``load_model``, as the CLI serves it (the config's
compute dtype, TF32 off, cuDNN's default algorithm choice), at B=1,
448x256: a preset of :data:`..config.PRESETS` with its committed
checkpoint (default: the shipped DAT_fast student), or a YAML file of any
ported model with ``--ckpt``. Traces ``--requests`` requests after
warm-up, and prints the device kernels by total time, the device
operations per request, the deformable sampler's share, the device's busy
share of the traced wall time, and the shares of six parts of the models
(``RANGES``: the device time of the kernels their calls launch, each call
traced inside a ``record_function`` range that only this tool opens): the
plain deformable convolution (``ops/dcn.py:deform_conv2d``), the Swin
decoders (``nn/swin.py:SwinDecoder``: DCNTrans's and GMTrans's two), the
forward-warp merges (``ops/warp.py:fwarp_using_two_frames``: GMTrans's
two splats per request, MADAT's one), GMTrans's feature transformer with
its global correlation (``nn/transformer.py``), and MADAT's full
attentions: its three self-attentions over every token of a level
(``nn/madat.py:FlowSelfAttnPropagation``) and its cross-frame attention
at 1/8 (``nn/madat.py:InterFrameAttention``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..config import PRESETS
from ..interpolate import config_and_ckpt, load_model
from ..nn import transformer
from ..nn.madat import FlowSelfAttnPropagation, InterFrameAttention
from ..nn.swin import SwinDecoder
from ..ops import dcn, warp
from ..train.trainer import device_events

# The traced parts: summary key -> the record_function range's name.
RANGES = {"dcn": "deform_conv2d", "swin": "swin_decoder", "splat": "fwarp_using_two_frames",
          "transformer": "feature_transformer", "self_attn": "flow_self_attn_propagation",
          "corr": "inter_frame_attention"}


@contextlib.contextmanager
def traced_as(fn, name: str):
    """While open, every module of the port that holds ``fn`` under a name
    calls it inside ``record_function(name)``."""
    def traced(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    root = __name__.split(".")[0]
    held = [(m, attr) for m in list(sys.modules.values())
            if getattr(m, "__name__", "").startswith(root)
            for attr, v in list(vars(m).items()) if v is fn]
    for m, attr in held:
        setattr(m, attr, traced)
    try:
        yield
    finally:
        for m, attr in held:
            setattr(m, attr, fn)


@contextlib.contextmanager
def traced_forward(cls, name: str):
    """While open, every call of ``cls``'s ``forward`` runs inside
    ``record_function(name)``."""
    forward = cls.forward

    def traced(self, *args, **kwargs):
        with record_function(name):
            return forward(self, *args, **kwargs)

    cls.forward = traced
    try:
        yield
    finally:
        cls.forward = forward


def range_device_ms(prof, names) -> dict[str, tuple[int, float]]:
    """For each host range of ``names``: the calls traced in it and the
    device time (ms) of the operations launched by the ops inside those
    calls, read from the profiler's raw events (each device operation
    carries the correlation id of the op that launched it)."""
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU
            and e.linked_correlation_id() == 0]
    launched_by = {e.correlation_id(): (e.start_thread_id(), e.start_ns()) for e in host}
    calls = {name: [(e.start_thread_id(), e.start_ns(), e.end_ns()) for e in host
                    if e.name() == name] for name in names}
    device = device_events(prof)
    out = {}
    for name, spans in calls.items():
        ms = 0.0
        for d in device:
            op = launched_by.get(d.linked_correlation_id())
            if op and any(thread == op[0] and a <= op[1] <= b for thread, a, b in spans):
                ms += d.duration_ns() / 1e6
        out[name] = (len(spans), ms)
    return out


def main(argv: list[str] | None = None) -> dict:
    """Profile as the arguments say; returns the summary."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="DAT_fast",
                        help=f"a preset ({', '.join(sorted(PRESETS))}) or a YAML file")
    parser.add_argument("--ckpt", default=None,
                        help="flax msgpack checkpoint (default: the preset's; required with "
                             "a YAML file)")
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--out", default=None, help="write the summary as JSON here")
    args = parser.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    cfg, ckpt = config_and_ckpt(args.config, args.ckpt)
    model = load_model(cfg, ckpt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x0 = torch.rand((1, 256, 448, 3), generator=gen, device="cuda")
    x1 = torch.roll(x0, (2, 4), dims=(1, 2))
    t = torch.full((1, 1, 1, 1), 0.5, device="cuda")
    with torch.inference_mode():
        for _ in range(5):
            model(x0, x1, t)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            model(x0, x1, t)
        end.record()
        torch.cuda.synchronize()
        frame_ms = start.elapsed_time(end) / 20
        with (traced_as(dcn.deform_conv2d, RANGES["dcn"]),
              traced_forward(SwinDecoder, RANGES["swin"]),
              traced_as(warp.fwarp_using_two_frames, RANGES["splat"]),
              traced_forward(transformer.FeatureTransformer, RANGES["transformer"]),
              traced_as(transformer.global_correlation_softmax, RANGES["transformer"]),
              traced_forward(FlowSelfAttnPropagation, RANGES["self_attn"]),
              traced_forward(InterFrameAttention, RANGES["corr"]),
              profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof):
            start = time.perf_counter()
            for _ in range(args.requests):
                model(x0, x1, t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3

    # Read from the profiler's raw events: building its Python event tree
    # (key_averages) takes seconds for these requests.
    by_name: dict[str, list] = {}
    for e in device_events(prof):
        if e.name() not in RANGES.values():
            row = by_name.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e6
    kernels = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    # Each traced call's range on the host: the device time of the kernels
    # launched inside it.
    ranged = range_device_ms(prof, RANGES.values())
    traced = {key: ranged[name] for key, name in RANGES.items()}
    busy_ms = sum(ms for _, (_, ms) in kernels)
    rows = [{"kernel": name[:120], "calls_per_request": n / args.requests,
             "ms_per_request": ms / args.requests, "share": ms / busy_ms if busy_ms else 0.0}
            for name, (n, ms) in kernels]
    sampler = [r for r in rows if "deformable_sample_kernel" in r["kernel"]]
    summary = {
        "card": card,
        "config": args.config,
        "model": cfg.model_name,
        "dtype": cfg.compute_dtype,
        "requests": args.requests,
        "device_ops_per_request": sum(n for _, (n, _) in kernels) / args.requests,
        "ms_per_frame_cuda_events": frame_ms,
        "wall_ms_per_request": wall_ms / args.requests,
        "device_busy_ms_per_request": busy_ms / args.requests,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "sampler_ms_per_request": sum(r["ms_per_request"] for r in sampler),
        "sampler_share_of_busy": sum(r["share"] for r in sampler),
        **{f"{key}_{field}": value for key, (calls, ms) in traced.items()
           for field, value in (("calls_per_request", calls / args.requests),
                                ("ms_per_request", ms / args.requests),
                                ("share_of_busy", ms / busy_ms if busy_ms else 0.0))},
        "top": rows[:args.top],
    }
    for r in rows[:args.top]:
        print(f"{r['ms_per_request']:9.4f} ms {r['share']:6.1%} x{r['calls_per_request']:5.1f}  "
              f"{r['kernel']}")
    print(json.dumps({k: v for k, v in summary.items() if k != "top"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
