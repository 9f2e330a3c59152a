"""Evaluation entry point: score a checkpoint on a benchmark loop (counterpart of the JAX CLI ``evaluate.py``).

Usage::

    python -m videoframeinterpolation_tpu_torch.evaluate [--config DAT_fast] [--ckpt c.ckpt] \
        [--benchmark vimeo90k|ucf101|snu|synthetic] [--ssim] [--batch_size 4] \
        [--tile 512] [--device cuda]

``--config`` names a preset of :data:`..config.PRESETS`; ``--ckpt``
defaults to its committed checkpoint. The model computes in fp32 whatever
the preset says, with TF32 off on the card, as the JAX CLI evaluates. The
dataset roots are the config's (``root``, ``ucf101_root``, ``snu_root``,
relative to the working directory, as in the JAX CLI); ``synthetic`` scores
64 held-out scenes of the procedural generator at 256x448 with the
config's seed. ``--tile N`` tiles frames larger than N pixels with a
per-pair, flow-sized overlap (:func:`..parallel.spatial.make_flow_aware_tiled`);
smaller frames run whole. The JAX CLI's ``--exp_name`` (an experiment
directory of the production trainer) and ``--window_sampling`` are not
ported yet and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from .config import PRESETS
from .eval import validate_snu, validate_synthetic, validate_ucf101, validate_vimeo90k
from .interpolate import load_model, make_infer

BENCHMARKS = ("vimeo90k", "ucf101", "snu", "synthetic")


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA VFI evaluation")
    parser.add_argument("--exp_name", type=str, default=None,
                        help="not ported yet (an experiment of the production trainer)")
    parser.add_argument("--config", choices=sorted(PRESETS), default="DAT_fast")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="flax msgpack checkpoint (default: the preset's)")
    parser.add_argument("--benchmark", type=str, default="vimeo90k", choices=BENCHMARKS)
    parser.add_argument("--ssim", action="store_true")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--window_sampling", action="store_true", help="not ported yet")
    parser.add_argument("--tile", type=int, default=0,
                        help="spatial tile size for HD frames (0 = off); the overlap is "
                             "sized per pair from the model's own flow estimate")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.exp_name:
        raise SystemExit("--exp_name is not ported yet: it reads an experiment of the "
                         "production trainer (ROADMAP.md, queue 1 item 5); use --config "
                         "and --ckpt")
    if args.window_sampling:
        raise SystemExit("--window_sampling is not ported yet (ROADMAP.md, queue 1 item 7)")

    preset = PRESETS[args.config]
    # fp32 evaluation for PSNR parity, whatever the preset computes in.
    cfg = dataclasses.replace(preset.config, compute_dtype="float32")
    model = load_model(cfg, Path(args.ckpt or preset.ckpt), device=args.device)
    print(f"Number of params: {sum(p.numel() for p in model.parameters())}")
    infer = make_infer(model, args.tile)
    device = next(model.parameters()).device
    if args.benchmark == "vimeo90k":
        return validate_vimeo90k(infer, cfg.root, batch_size=args.batch_size,
                                 report_ssim=args.ssim, device=device)
    if args.benchmark == "ucf101":
        return validate_ucf101(infer, root=cfg.ucf101_root, report_ssim=args.ssim,
                               device=device)
    if args.benchmark == "synthetic":
        return validate_synthetic(infer, seed=cfg.seed, report_ssim=args.ssim,
                                  batch_size=args.batch_size, device=device)
    return validate_snu(infer, root=cfg.snu_root, report_ssim=args.ssim, device=device)


if __name__ == "__main__":
    main()
