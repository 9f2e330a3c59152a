"""What every probe needs: the card's name and limit, CUDA-event timing, the bytes bound."""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet


def require_card() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it;
    raises when there is no CUDA device (a probe does not fall back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes measure the card and have no CPU mode")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def loop_ms(fn: Callable[[], object], n: int, warmup: int = 3) -> float:
    """Milliseconds of ``n`` back-to-back calls of ``fn`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def marginal_ms(fn: Callable[[], object], n_hi: int, repeats: int = 3) -> float:
    """Milliseconds per call at the margin: ``(t(n_hi) - t(1)) / (n_hi - 1)``,
    as the JAX probes time, so that the fixed cost of a timed loop drops
    out. Each ``t`` is the least of ``repeats`` timed loops."""
    t1 = min(loop_ms(fn, 1) for _ in range(repeats))
    t_hi = min(loop_ms(fn, n_hi) for _ in range(repeats))
    return (t_hi - t1) / (n_hi - 1)


def graph_ms(fn: Callable[[], object], n: int, replays: int = 3) -> float:
    """Milliseconds of ``n`` calls of ``fn`` captured in one CUDA graph, the
    least of ``replays`` replays: the device's time, without the host's
    cost of issuing each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):   # warm-up on a side stream, as graph capture asks
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_marginal_ms(fn: Callable[[], object], n_hi: int) -> float:
    """:func:`marginal_ms` on the device's clock: ``(g(n_hi) - g(1)) /
    (n_hi - 1)`` with ``g`` from :func:`graph_ms`, as the JAX probes time
    a loop inside one compiled program."""
    return (graph_ms(fn, n_hi) - graph_ms(fn, 1)) / (n_hi - 1)


def device_ops(fn: Callable[[], object]) -> list[str]:
    """The names of the device operations (kernels, fills, copies) that one
    call of ``fn`` issues, from ``torch.profiler``'s CUDA trace, after one
    call to warm up. Raises when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise RuntimeError("torch.profiler recorded no device operation")
    return ops


def bytes_bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` through its memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3
