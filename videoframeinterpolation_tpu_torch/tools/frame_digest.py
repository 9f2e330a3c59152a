"""A digest of the frame the card serves for a fixed request, to compare two trees bit for bit.

    python -m videoframeinterpolation_tpu_torch.tools.frame_digest

Serves the shipped DAT_fast student through ``load_model`` (the config's
bf16, TF32 off) at B=1, 448x256, t=0.5, on random frames made from a seeded
generator on the card, and prints one JSON line: the SHA-256 of the model's
output bytes, its shape and dtype, and the card. Two trees whose kernels
compute the same arithmetic print the same digest on the same card. Needs a
CUDA device.
"""

from __future__ import annotations

import hashlib
import json

import torch

from ..config import DAT_fast
from ..interpolate import SHIPPED_STUDENT, load_model
from .perf.timing import require_card


def main() -> dict:
    card = require_card()
    model = load_model(DAT_fast, SHIPPED_STUDENT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x0 = torch.rand((1, 256, 448, 3), generator=gen, device="cuda")
    x1 = torch.roll(x0, (2, 4), dims=(1, 2))
    t = torch.full((1, 1, 1, 1), 0.5, device="cuda")
    with torch.inference_mode():
        out = model(x0, x1, t).float().cpu().contiguous()
    row = {"sha256": hashlib.sha256(out.numpy().tobytes()).hexdigest(),
           "shape": list(out.shape), "dtype": str(model.dtype), "card": card}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
