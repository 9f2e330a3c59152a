"""Held-out PSNR and SSIM of committed checkpoints (counterpart of ``tools/quality/eval_best.py``).

    python -m videoframeinterpolation_tpu_torch.tools.eval_best --config DAT_fast \
        [--ckpt a.best.ckpt ...] [--eval_items 32] [--crop 128] [--seed 42] \
        [--device cuda] [--out results.jsonl]
    python -m videoframeinterpolation_tpu_torch.tools.eval_best --ckpt c.ckpt \
        [--model DATwConstantnCv1] [--nf 72] [--shared] [--samples 8,8,4] [--dec_res_blocks 10]

Scores each checkpoint on the held-out pool of the quality study:
``SyntheticMotion`` scenes of the held-out split, ``--seed`` 42, 32 scenes
at 128x128 and t = 0.5 (:func:`build_pool`, as
``tools/quality/head_to_head.py:build_pool`` builds it). The protocol is
the JAX tool's: the preset's architecture served in fp32
(``compute_dtype="float32"``, TF32 off on the card for the model and for
the metrics' ``conv3d``), batches of 8, the PSNR of the prediction as the
model returns it (no further clipping) and the 3-D SSIM with
``val_range=1.0``, per item, then the mean over items. ``--ckpt`` defaults
to the preset's committed checkpoint. The JAX tool's architecture flags
(``--model``, ``--nf``, ``--shared``, ``--samples``, ``--dec_res_blocks``)
override ``--config``: with any of them the architecture is the JAX tool's,
those flags over its defaults (``DATwConstantnCv1``, nf 72, not shared,
samples 8/16/32, 10 decoder blocks), and ``--ckpt`` is required. Prints
one JSON line per checkpoint with ``eval_best.jsonl``'s keys and, with
``--out``, appends it to that file; nothing is written without ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..config import PRESETS, Config
from ..data import SyntheticMotion
from ..eval import psnr, ssim_3d
from ..interpolate import load_model, resolve_device
from ..train import read_flax_state

POOL_KEYS = ("x0", "x1", "xt", "t", "f0x", "f1x")
EVAL_BATCH = 8


def build_pool(n_scenes: int, crop: tuple, seed: int, is_train: bool, **ds_kwargs) -> dict:
    """A fixed pool of ``n_scenes`` scenes: ``{key: stacked numpy array}``
    for ``x0, x1, xt, t, f0x, f1x``. ``ds_kwargs`` pass through to
    ``SyntheticMotion`` (``fixed_t`` for a per-instant pool; t = 0.5
    without)."""
    ds = SyntheticMotion(crop_hw=crop, is_train=is_train, seed=seed, num_items=n_scenes,
                         **ds_kwargs)
    items = [ds[i] for i in range(n_scenes)]
    return {k: np.stack([it[k] for it in items]) for k in POOL_KEYS}


@torch.inference_mode()
def score(model: torch.nn.Module, pool: dict) -> dict:
    """The mean over items of each item's PSNR and SSIM (``val_range=1.0``)
    of ``model`` on ``pool``, inferred in batches of ``EVAL_BATCH``;
    computed on the model's device."""
    device = next(model.parameters()).device
    ps, ss = [], []
    for i in range(0, len(pool["x0"]), EVAL_BATCH):
        x0, x1, t, gt = (torch.from_numpy(pool[k][i:i + EVAL_BATCH]).to(device)
                         for k in ("x0", "x1", "t", "xt"))
        pred = model(x0, x1, t)
        for j in range(pred.shape[0]):
            ps.append(psnr(pred[j], gt[j]).item())
            ss.append(ssim_3d(pred[j:j + 1], gt[j:j + 1], val_range=1.0).item())
    return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss)), "n": len(ps)}


def evaluate(cfg: Config, ckpts, eval_items: int = 32, crop: int = 128, seed: int = 42,
             device: str = "cuda", ts=None) -> list[dict]:
    """Score each checkpoint of ``ckpts`` (same architecture, ``cfg``) on
    the held-out pool; one record per checkpoint with ``eval_best.jsonl``'s
    keys, PSNR and SSIM unrounded. With ``ts``, one record per (checkpoint,
    t) on a ``fixed_t`` pool per instant, with ``eval_instants.jsonl``'s
    keys (``t`` rounded to 4 places, as the JAX tool writes it). On CUDA,
    TF32 is switched off for cuDNN and matmuls before anything runs."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    pools = ({None: build_pool(eval_items, (crop, crop), seed, is_train=False)} if ts is None
             else {t: build_pool(eval_items, (crop, crop), seed, is_train=False, fixed_t=t)
                   for t in ts})
    records = []
    for ckpt in ckpts:
        model = load_model(dataclasses.replace(cfg, compute_dtype="float32"), ckpt,
                           device=device)
        step = int(read_flax_state(ckpt)["step"])
        for t, pool in pools.items():
            result = score(model, pool)
            records.append({"ckpt": str(ckpt), "step": step,
                            **({} if t is None else {"t": round(t, 4)}),
                            "psnr": result["psnr"], "ssim": result["ssim"], "n": result["n"],
                            "crop": crop, "seed": seed})
        del model
    return records


ARCH_FLAGS = ("model", "nf", "shared", "samples", "dec_res_blocks")


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The flags this tool and ``tools/eval_instants.py`` share."""
    ap.add_argument("--config", choices=sorted(PRESETS), default="DAT_fast")
    ap.add_argument("--ckpt", nargs="+", default=None,
                    help="one or more checkpoints of one architecture "
                         "(default: the preset's committed checkpoint)")
    ap.add_argument("--model", default=None, help="the JAX tool's flag (DATwConstantnCv1)")
    ap.add_argument("--nf", type=int, default=None, help="the JAX tool's flag (72)")
    ap.add_argument("--shared", action="store_true", default=None,
                    help="the JAX tool's flag (off)")
    ap.add_argument("--samples", default=None,
                    help="the JAX tool's flag: a comma triple, e.g. 8,8,4 (8,16,32)")
    ap.add_argument("--dec_res_blocks", type=int, default=None,
                    help="the JAX tool's flag (10)")
    ap.add_argument("--eval_items", type=int, default=32)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSONL file to append each record to "
                                                "(default: none; print only)")


def config_and_ckpts(args: argparse.Namespace) -> tuple[Config, list]:
    """The architecture and the checkpoints the flags name: the preset's,
    or, with any of :data:`ARCH_FLAGS`, the JAX tool's defaults under those
    flags (which needs ``--ckpt``)."""
    preset = PRESETS[args.config]
    if all(getattr(args, f) is None for f in ARCH_FLAGS):
        return preset.config, args.ckpt or [preset.ckpt]
    if not args.ckpt:
        raise SystemExit(f"--{', --'.join(ARCH_FLAGS)} describe a checkpoint of no preset: "
                         "pass it with --ckpt")
    samples = (tuple(int(x) for x in args.samples.split(",")) if args.samples
               else (8, 16, 32))
    cfg = dataclasses.replace(preset.config, model_name=args.model or "DATwConstantnCv1",
                              nf=args.nf or 72, shared_offsets=bool(args.shared),
                              dat_samples=samples, dec_res_blocks=args.dec_res_blocks or 10)
    return cfg, args.ckpt


def report(records: list[dict], out: str | None) -> None:
    """Print each record as a JSON line, PSNR and SSIM rounded as the JAX
    tools write them, and append the lines to ``out`` when it is given."""
    for rec in records:
        line = json.dumps({**rec, "psnr": round(rec["psnr"], 4), "ssim": round(rec["ssim"], 5)})
        print(line, flush=True)
        if out:
            with Path(out).open("a") as f:
                f.write(line + "\n")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arguments(ap)
    args = ap.parse_args(argv)

    cfg, ckpts = config_and_ckpts(args)
    records = evaluate(cfg, ckpts, args.eval_items, args.crop, args.seed, args.device)
    report(records, args.out)
    return records


if __name__ == "__main__":
    main()
