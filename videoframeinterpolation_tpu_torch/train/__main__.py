"""Training entry point (counterpart of the JAX CLI ``train.py``).

Usage::

    python -m videoframeinterpolation_tpu_torch.train --exp_name my_exp \
        --config configs/DAT.yaml [--resume latest] [--set KEY=VALUE ...] \
        [--profile_steps 10,13] [--device cuda]
    torchrun --nproc_per_node 4 -m videoframeinterpolation_tpu_torch.train \
        --multihost --exp_name my_exp --config configs/DAT.yaml

``--config`` is a YAML file of the repository's subset
(:mod:`..utils.yaml_subset`); ``--set`` values are read by the same reader,
as scalars or flow lists (``--set "dat_samples=[8, 16, 8]"``). The run
writes under ``exps/<exp_name>`` (the config's ``log_dir``):
``config.yaml``, ``metrics.jsonl``, ``images/`` and
``checkpoints/<name>.ckpt`` with ``<name>.meta.json``. ``--resume``
names a checkpoint there. ``--multihost`` joins the process group that
``torchrun`` describes in the environment (:mod:`..parallel.ddp`), one
process per card, each with a batch of ``batch_size``. ``--profile_steps
START,STOP`` traces those steps with ``torch.profiler`` into
``<log_dir>/profile``. The run is on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from ..config import Config
from ..parallel import ddp
from ..utils.yaml_subset import parse_value
from .trainer import Trainer


def parse_overrides(items: list[str]) -> dict:
    overrides = {}
    for kv in items:
        key, sep, value = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        overrides[key] = parse_value(value, f"--set {key}")
    return overrides


def main(argv: list[str] | None = None) -> Trainer:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA VFI training")
    parser.add_argument("--exp_name", default="debug", type=str)
    parser.add_argument("--config", type=str, default="configs/DAT.yaml")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint name under <log_dir>/checkpoints (e.g. 'latest')")
    parser.add_argument("--multihost", action="store_true",
                        help="join the torchrun process group (one process per card)")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="config-field override, YAML-parsed; repeatable (e.g. --set "
                             "teacher_ckpt=exps/teacher/checkpoints/best_vimeo90k --set "
                             "'dat_samples=[8, 16, 8]')")
    parser.add_argument("--profile_steps", type=str, default=None, metavar="START,STOP",
                        help="trace steps START..STOP-1 with torch.profiler")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    profile_steps = None
    if args.profile_steps:
        start, stop = (int(x) for x in args.profile_steps.split(","))
        profile_steps = (start, stop)
    cfg = Config.from_yaml(args.config, exp_name=args.exp_name,
                           **parse_overrides(args.overrides))
    world = ddp.world_from_env() if args.multihost else ddp.World(0, 1, 0)
    trainer = Trainer(cfg, device=args.device, world=world)
    try:
        if args.resume:
            trainer.resume(args.resume)
        trainer.train(profile_steps=profile_steps)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
