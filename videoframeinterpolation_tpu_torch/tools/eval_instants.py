"""Per-instant held-out PSNR and SSIM of checkpoints (counterpart of ``tools/quality/eval_instants.py``).

    python -m videoframeinterpolation_tpu_torch.tools.eval_instants [--config DAT_fast] \
        [--ckpt c.ckpt ...] [--model ...] [--nf 72] [--shared] [--samples 8,8,2] \
        [--dec_res_blocks 10] [--instants 1/8,2/8,3/8,4/8,5/8,6/8,7/8] \
        [--eval_items 32] [--crop 128] [--seed 42] [--device cuda] [--out results.jsonl]

Scores each checkpoint at every instant of ``--instants`` (the factor-8
serving grid by default) on held-out pools rendered at that instant: the
quality study's pool (``--seed`` 42, 32 scenes at 128x128) with
``fixed_t``, so the pools of two instants share their scenes byte for byte
and differ only in the true frame. The protocol is ``tools/eval_best.py``'s
(its ``evaluate`` with ``ts``: fp32, TF32 off on the card, batches of 8,
per-item PSNR and SSIM with ``val_range=1.0``, then the mean), as is the
choice of architecture
(``--config``, or the JAX tool's flags). Prints one JSON line per
(checkpoint, t) with ``eval_instants.jsonl``'s keys and, with ``--out``,
appends it there; nothing is written without ``--out``.
"""

from __future__ import annotations

import argparse

from .eval_best import add_arguments, config_and_ckpts, evaluate, report

DEFAULT_INSTANTS = "1/8,2/8,3/8,4/8,5/8,6/8,7/8"


def parse_instants(text: str) -> list[float]:
    """``"1/8,0.5"`` -> ``[0.125, 0.5]``, as the JAX tool parses them."""
    ts = []
    for frac in text.split(","):
        num, den = frac.split("/") if "/" in frac else (frac, "1")
        ts.append(float(num) / float(den))
    return ts


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arguments(ap)
    ap.add_argument("--instants", default=DEFAULT_INSTANTS,
                    help="comma list of fractions (the factor-8 serving grid by default)")
    args = ap.parse_args(argv)

    cfg, ckpts = config_and_ckpts(args)
    records = evaluate(cfg, ckpts, args.eval_items, args.crop, args.seed, args.device,
                       ts=parse_instants(args.instants))
    report(records, args.out)
    return records


if __name__ == "__main__":
    main()
