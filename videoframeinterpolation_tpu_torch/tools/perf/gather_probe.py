"""Row-gather probe on the card: counterpart of ``tools/perf/pallas_gather_probe.py``.

    python -m videoframeinterpolation_tpu_torch.tools.perf.gather_probe

At each shape of the JAX probe (``x (M, 128)`` fp32 for M in 1024, 8192 and
28672, ``idx (M, 128)`` int32 uniform in ``[0, M)``, both from a seeded
generator on the card) it calls :func:`..kernels.row_gather` once, checks
that the result equals :func:`..kernels.row_gather_plain` exactly, and times
the kernel at the margin, ``(t(17) - t(1)) / 16`` as the JAX probe does:
on the device's clock (the calls captured in a CUDA graph, as the JAX probe
loops inside one compiled program) and, as ``host``, issued one by one from
Python, wrapper included. It prints the index width the wrapper took
(:func:`..kernels.gather._row_index_bits`), us/call and Mrow/s, the bytes bound
(each input read once and the output written once, over 3.35 TB/s), and
the time of the plain version (issued from Python) and of ``torch.gather``
(device clock) on the same work, with its int64 index built before the
timed loop. Needs a CUDA device, and raises without one.

Only the checked call counts in ``row_gather.launches``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...kernels import row_gather, row_gather_plain
from ...kernels.gather import _row_index_bits
from .timing import bytes_bound_ms, device_marginal_ms, marginal_ms, require_card

SHAPES = ((1024, 128, torch.float32), (8192, 128, torch.float32), (28672, 128, torch.float32))
N_HI = 17


def probe(kernel: Callable, plain: Callable, axis: int, M: int, N: int, dtype: torch.dtype,
          n_hi: int, gen: torch.Generator) -> dict:
    """One shape: the kernel's one counted call, its exact check against the
    plain version, and the times of kernel, plain version and ``torch.gather``."""
    x = torch.randn((M, N), generator=gen, device="cuda", dtype=dtype)
    idx = torch.randint(0, (M, N)[axis], (M, N), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = kernel(x, idx)
    ref = plain(x, idx)
    exact = torch.equal(out, ref)
    calls = kernel.launches
    ms = device_marginal_ms(lambda: kernel(x, idx), n_hi)
    host_ms = marginal_ms(lambda: kernel(x, idx), n_hi)
    kernel.launches = calls   # timing launches are not the probe's launch
    plain_ms = marginal_ms(lambda: plain(x, idx), n_hi)
    idx64 = idx.long()
    library_ms = device_marginal_ms(lambda: torch.gather(x, axis, idx64), n_hi)
    nbytes = (x.numel() + out.numel()) * x.element_size() + idx.numel() * idx.element_size()
    bound_ms = bytes_bound_ms(nbytes)
    return {"shape": [M, N], "dtype": str(dtype).removeprefix("torch."), "exact": exact,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(), "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "share_of_bound": bound_ms / ms if ms > 0 else None}


def main() -> list[dict]:
    card = require_card()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for M, N, dtype in SHAPES:
        r = probe(row_gather, row_gather_plain, 0, M, N, dtype, N_HI, gen)
        r["index_bits"] = _row_index_bits(M, N, M)
        us = r["ms"] * 1e3
        print(f"M={M}: correct={r['exact']} max|diff|={r['max_abs_err']}  "
              f"{r['index_bits']}-bit indices  {us:.2f} us/call  "
              f"{M / (us * 1e-6) / 1e6:.1f} Mrow/s  host {r['host_ms'] * 1e3:.1f} us/call  "
              f"bound {r['bound_ms'] * 1e3:.2f} us  "
              f"plain {r['plain_ms'] * 1e3:.1f} us  torch.gather {r['library_ms'] * 1e3:.2f} us  "
              f"[{card}]", flush=True)
        if not r["exact"]:
            raise AssertionError(f"row_gather differs from its plain version at M={M}")
        results.append(r)
    return results


if __name__ == "__main__":
    main()
