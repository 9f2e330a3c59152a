"""How chaotic a phase-15 family of ``chip_smoke.py`` is in bf16, on the CPU (a script, not a test).

    python tests/bf16_spread.py [--family DCNTrans] [--gains 1,0.5] [--norm_scale 1]
        [--size 256x448]

For each kernel gain, the family's parameters are drawn as
``chip_smoke.seeded_state`` draws them from ``chip_smoke.FAMILY_SEED``
with that gain and the LayerNorm scales at ``--norm_scale`` (default: the
family's ``chip_smoke.FAMILY_NORM_SCALE``), and the port's fp32 and bf16 frames are taken on the
CPU at t = 0.5 on the held-out scene ``chip_smoke.FAMILY_SCENE`` (at
``--size``). Prints one JSON line per gain: the bf16-vs-fp32 gap (mean
abs), the spread (mean abs move of the bf16 frame when frame 0 moves by
1e-6, far below bf16's resolution) and the spread's share of the gap.
``chip_smoke.card_vs_cpu`` holds the card's bf16 frame to half of that
gap, which no device can meet where the spread alone exceeds it.
``FAMILY_KERNEL_GAIN`` and ``FAMILY_NORM_SCALE`` were chosen with it.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from videoframeinterpolation_tpu_torch.models import create_model  # noqa: E402
from videoframeinterpolation_tpu_torch.tools import fixtures  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="DCNTrans", choices=sorted(chip_smoke.FAMILIES))
    ap.add_argument("--gains", default="1,0.5")
    ap.add_argument("--norm_scale", type=float, default=None)
    ap.add_argument("--size", default="x".join(map(str, chip_smoke.FAMILY_SCENE[0])))
    args = ap.parse_args(argv)
    norm_scale = (chip_smoke.FAMILY_NORM_SCALE.get(args.family, 1.0)
                  if args.norm_scale is None else args.norm_scale)
    hw = tuple(int(v) for v in args.size.split("x"))
    f0, _, f1 = fixtures.triplet(hw, chip_smoke.FAMILY_SCENE[1])
    x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None] for f in (f0, f1))
    t = torch.full((1, 1, 1, 1), 0.5)
    cfg = chip_smoke.family_config(args.family)
    for gain in (float(g) for g in args.gains.split(",")):
        params = chip_smoke.seeded_state(cfg, chip_smoke.FAMILY_SEED, gain,
                                         norm_scale).model.state_dict()
        out = {}
        for dtype in ("float32", "bfloat16"):
            model = create_model(dataclasses.replace(cfg, compute_dtype=dtype))
            model.load_state_dict(params)
            with torch.inference_mode():
                out[dtype] = model.eval()(x0, x1, t)
                if dtype == "bfloat16":
                    out["moved"] = model(x0 + 1e-6, x1, t)
        gap = (out["bfloat16"] - out["float32"]).abs().mean().item()
        spread = (out["moved"] - out["bfloat16"]).abs().mean().item()
        print(json.dumps({"family": args.family, "size": list(hw), "kernel_gain": gain,
                          "norm_scale": norm_scale,
                          "bf16_vs_fp32_mean_abs": gap, "spread_mean_abs": spread,
                          "spread_share_of_gap": spread / gap}), flush=True)


if __name__ == "__main__":
    main()
