"""Lane-gather probe on the card: counterpart of ``tools/perf/pallas_lane_gather_probe.py``.

    python -m videoframeinterpolation_tpu_torch.tools.perf.lane_gather_probe

At each shape of the JAX probe (``x (M, 128)`` for (M, dtype) in (8, fp32),
(256, fp32), (4096, fp32), (4096, bf16) and (32768, fp32); ``idx (M, 128)``
int32 uniform in ``[0, 128)``) it calls :func:`..kernels.lane_gather` once,
checks that the result equals :func:`..kernels.lane_gather_plain` exactly,
and times the kernel at the margin, ``(t(64) - t(1)) / 63``, on the
device's clock and issued from Python, as :mod:`.gather_probe` does. It
prints us/gather and Gelem/s, the bytes bound and the time of the plain
version and of ``torch.gather`` on the same work. Needs a CUDA device, and raises without one.

Only the checked call counts in ``lane_gather.launches``.
"""

from __future__ import annotations

import torch

from ...kernels import lane_gather, lane_gather_plain
from .gather_probe import probe
from .timing import require_card

SHAPES = ((8, 128, torch.float32), (256, 128, torch.float32), (4096, 128, torch.float32),
          (4096, 128, torch.bfloat16), (32768, 128, torch.float32))
N_HI = 64


def main() -> list[dict]:
    card = require_card()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for M, N, dtype in SHAPES:
        r = probe(lane_gather, lane_gather_plain, 1, M, N, dtype, N_HI, gen)
        us = r["ms"] * 1e3
        print(f"M={M} {r['dtype']}: ok={r['exact']} max|diff|={r['max_abs_err']}  "
              f"~{us:.1f} us/gather ({M * N / (us * 1e-6) / 1e9:.1f} Gelem/s)  "
              f"host {r['host_ms'] * 1e3:.1f} us/gather  "
              f"bound {r['bound_ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.1f} us  "
              f"torch.gather {r['library_ms'] * 1e3:.1f} us  [{card}]", flush=True)
        if not r["exact"]:
            raise AssertionError(f"lane_gather differs from its plain version at M={M} {dtype}")
        results.append(r)
    return results


if __name__ == "__main__":
    main()
