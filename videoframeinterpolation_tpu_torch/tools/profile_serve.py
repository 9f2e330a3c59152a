"""Where a 448x256 request's time goes on the card: a torch.profiler trace.

    python -m videoframeinterpolation_tpu_torch.tools.profile_serve \
        [--config DAT_fast|configs/IFRNet.yaml --ckpt c.ckpt] [--out profile_serve.json]

Serves a model through ``load_model``, as the CLI serves it (the config's
compute dtype, TF32 off, cuDNN's default algorithm choice), at B=1,
448x256: a preset of :data:`..config.PRESETS` with its committed
checkpoint (default: the shipped DAT_fast student), or a YAML file of any
ported model with ``--ckpt``. Traces ``--requests`` requests after
warm-up, and prints the device kernels by total time, the device
operations per request, the deformable sampler's share, the plain
deformable convolution's share (``ops/dcn.py:deform_conv2d``: the device
time of the kernels its calls launch, each call traced inside a
``record_function`` range that only this tool opens), the Swin decoders'
share (``nn/swin.py:SwinDecoder``, DCNTrans's two decoders, traced the
same way) and the device's busy share of the traced wall time. Needs a
CUDA device.
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
from ..nn.swin import SwinDecoder
from ..ops import dcn

DCN_RANGE = "deform_conv2d"
SWIN_RANGE = "swin_decoder"


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


def _range_ms(prof, name: str) -> tuple[int, float]:
    """The calls traced in host range ``name`` and the device time (ms) of
    the kernels launched inside them."""
    calls = [e for e in prof.events()
             if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    return len(calls), sum(e.device_time_total for e in calls) / 1e3


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
        with (traced_as(dcn.deform_conv2d, DCN_RANGE), traced_forward(SwinDecoder, SWIN_RANGE),
              profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof):
            start = time.perf_counter()
            for _ in range(args.requests):
                model(x0, x1, t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
               and e.key not in (DCN_RANGE, SWIN_RANGE)]
    # Each traced call's range on the host: the device time of the kernels
    # launched inside it.
    dcn_calls, dcn_ms = _range_ms(prof, DCN_RANGE)
    swin_calls, swin_ms = _range_ms(prof, SWIN_RANGE)
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    rows = [{"kernel": e.key[:120], "calls_per_request": e.count / args.requests,
             "ms_per_request": e.device_time_total / 1e3 / args.requests,
             "share": e.device_time_total / 1e3 / busy_ms if busy_ms else 0.0}
            for e in kernels]
    sampler = [r for r in rows if "deformable_sample_kernel" in r["kernel"]]
    summary = {
        "card": card,
        "config": args.config,
        "model": cfg.model_name,
        "dtype": cfg.compute_dtype,
        "requests": args.requests,
        "device_ops_per_request": sum(e.count for e in kernels) / args.requests,
        "ms_per_frame_cuda_events": frame_ms,
        "wall_ms_per_request": wall_ms / args.requests,
        "device_busy_ms_per_request": busy_ms / args.requests,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "sampler_ms_per_request": sum(r["ms_per_request"] for r in sampler),
        "sampler_share_of_busy": sum(r["share"] for r in sampler),
        "dcn_calls_per_request": dcn_calls / args.requests,
        "dcn_ms_per_request": dcn_ms / args.requests,
        "dcn_share_of_busy": dcn_ms / busy_ms if busy_ms else 0.0,
        "swin_calls_per_request": swin_calls / args.requests,
        "swin_ms_per_request": swin_ms / args.requests,
        "swin_share_of_busy": swin_ms / busy_ms if busy_ms else 0.0,
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
