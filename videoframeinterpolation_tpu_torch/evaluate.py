"""Evaluation entry point: score a checkpoint on a benchmark loop (counterpart of the JAX CLI ``evaluate.py``).

Usage::

    python -m videoframeinterpolation_tpu_torch.evaluate --exp_name my_exp [--ckpt best_vimeo90k]
    python -m videoframeinterpolation_tpu_torch.evaluate [--config DAT_fast|c.yaml] [--ckpt c.ckpt] \
        [--benchmark vimeo90k|ucf101|snu|synthetic] [--ssim] [--batch_size 4] \
        [--tile 512] [--device cuda]

``--exp_name`` names a training run: its ``exps/<name>/config.yaml``
(written by the port's trainer or the JAX trainer, read by the port's YAML
reader) and, under the config's ``log_dir``, the checkpoint
``checkpoints/<--ckpt>.ckpt`` (default ``best_<save_best_benchmark>``),
as the JAX CLI finds them. Otherwise ``--config`` names a preset of
:data:`..config.PRESETS` or a YAML file, and ``--ckpt`` is a flax msgpack
checkpoint file (default: the preset's committed one); with both
``--config`` and ``--exp_name``, the checkpoint is the run's. The model
computes in fp32 whatever the config says, with TF32 off on the card, as
the JAX CLI evaluates. The dataset roots are the config's (``root``,
``ucf101_root``, ``snu_root``, relative to the working directory, as in
the JAX CLI); ``synthetic`` scores 64 held-out scenes of the procedural
generator at 256x448 with the config's seed. ``--tile N`` tiles frames
larger than N pixels with a per-pair, flow-sized overlap
(:func:`..parallel.spatial.make_flow_aware_tiled`); smaller frames run
whole. IFRNet, DCNDAT and DCNTrans cannot be tiled (they return no
``pred_ft0`` flow pyramid to size the overlap): ``--tile`` with any of them
fails before the model runs.
``--window_sampling`` sets the config's ``window_sampling``, as the JAX
CLI does; it is the same function with the same parameters, so the port
runs the same kernel and gives the same scores.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from .config import PRESETS, Config
from .eval import validate_snu, validate_synthetic, validate_ucf101, validate_vimeo90k
from .interpolate import load_model, make_infer
from .train import CheckpointManager

BENCHMARKS = ("vimeo90k", "ucf101", "snu", "synthetic")


def resolve(args: argparse.Namespace) -> tuple[Config, Path]:
    """The config and checkpoint file that ``--exp_name``, ``--config`` and
    ``--ckpt`` name."""
    exp_name = args.exp_name or "eval"
    if args.config in PRESETS:
        cfg, ckpt = PRESETS[args.config]
        cfg = dataclasses.replace(cfg, exp_name=exp_name, log_dir="")
    elif args.config:
        cfg, ckpt = Config.from_yaml(args.config, exp_name=exp_name), None
    elif args.exp_name:
        cfg, ckpt = Config.from_yaml(Path("exps") / args.exp_name / "config.yaml"), None
    else:
        cfg, ckpt = PRESETS["DAT_fast"]
    if args.exp_name:
        run = CheckpointManager(cfg.log_dir, create=False)
        name = args.ckpt or f"best_{cfg.save_best_benchmark}"
        if (run.dir / name).is_dir():
            raise SystemExit(f"{run.dir / name} is an Orbax checkpoint of the JAX trainer; "
                             "the port reads the .ckpt files (flax msgpack) of its own trainer")
        ckpt = run.path(name)
    elif args.ckpt:
        ckpt = Path(args.ckpt)
    if ckpt is None:
        raise SystemExit("--config with a YAML file needs --ckpt (a checkpoint file) or "
                         "--exp_name (a training run)")
    return cfg, ckpt


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA VFI evaluation")
    parser.add_argument("--exp_name", type=str, default=None,
                        help="a training run: exps/<name>/config.yaml and its checkpoints")
    parser.add_argument("--config", type=str, default=None,
                        help=f"a preset ({', '.join(sorted(PRESETS))}) or a YAML file "
                             "(default: DAT_fast, or the run's config with --exp_name)")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="with --exp_name, a checkpoint name (default "
                             "best_<save_best_benchmark>); else a flax msgpack checkpoint "
                             "file (default: the preset's)")
    parser.add_argument("--benchmark", type=str, default="vimeo90k", choices=BENCHMARKS)
    parser.add_argument("--ssim", action="store_true")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--window_sampling", action="store_true",
                        help="the config's window_sampling: the same function and parameters "
                             "(any flagship checkpoint works)")
    parser.add_argument("--tile", type=int, default=0,
                        help="spatial tile size for HD frames (0 = off); the overlap is "
                             "sized per pair from the model's own flow estimate")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg, ckpt = resolve(args)
    # fp32 evaluation for PSNR parity, whatever the config computes in.
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              window_sampling=cfg.window_sampling or args.window_sampling)
    model = load_model(cfg, ckpt, device=args.device)
    print(f"Number of params: {sum(p.numel() for p in model.parameters())}")
    try:
        infer = make_infer(model, args.tile)
    except ValueError as e:
        raise SystemExit(f"{cfg.model_name}: {e}") from None
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
