"""The quality study's trainer (counterpart of ``tools/quality/head_to_head.py``).

    python -m videoframeinterpolation_tpu_torch.tools.head_to_head \
        --model DATwConstantnCv1 --shared --samples 8,8,2 --steps 24000 --warmup 500 \
        --distill_from configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt \
        --teacher_shared --teacher_samples 8,16,8 --distill_w 1.0 \
        --out_dir runs/ [--resume] [--stop_at N] [--device cuda]

Trains a DAT-family model (the flagship ``DATwConstantnCv1``, with its
variants ``--shared`` or ``--shared_levels``, ``--samples``,
``--attn_stride``, ``--movement_nf`` and ``--dec_res_blocks``; or
``DATwConstantnCTPU``, with ``--dilated`` for the dilated taps
``OFFSET_SETS`` and ``--goff`` for 4/8/8 learned offset groups) from
scratch (or, with ``--resume``, from ``<out_dir>/<tag>.ckpt``) on the
quality study's fixed pool of
``SyntheticMotion`` scenes, with the JAX tool's recipe: bf16 compute over
fp32 master parameters, AdamW over the warmup-cosine schedule
(``start_lr`` 2e-4 to ``end_lr`` 1e-5 at ``--steps``), the flagship's loss
(Charbonnier, census, flow distillation) and, with ``--distill_from``, the
frozen teacher's output distillation ``distill_w * Charbonnier(pred -
pred_teacher)``; the teacher (``--teacher_shared``, ``--teacher_samples``,
``--teacher_nf``; the other options at their defaults, as the JAX tool
builds it) is served in bf16. ``--random_t lo,hi`` draws the training
pool's instants from that range (the held-out pool stays at t = 0.5). The
pool lives on the device and each batch is gathered there, or, with
``--host_pool``, stays on the host and each batch is copied over; the
batches are the same bits either way. Each step draws its batch
indices from ``np.random.PCG64(seed + 777)``, as the JAX tool does, and a
resumed run fast-forwards that sampler by ``step`` draws, so the batch
stream and the schedule are those of an uninterrupted run; the held-out
PSNR is ``tools/eval_best.py``'s ``score`` in fp32 (TF32 off on the card).

The tag, the jsonl events (``start``, ``resume``, ``eval``, ``final`` or
``stop``), the best-PSNR watermark of a resumed curve and the ``.ckpt`` /
``.best.ckpt`` files (flax msgpack TrainStates, readable by the JAX tools)
are the JAX tool's. ``--out_dir`` has no default, so the committed curves
under ``tools/quality/results`` are never appended to. ``--chunk`` is the
number of steps between two reads of the loss on the host (the JAX tool
scans that many steps in one dispatch); it must divide ``--eval_every``
and ``--steps``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..interpolate import load_model, resolve_device
from ..models import create_model
from ..train import (create_train_state, make_distill_loss_fn, make_loss_fn, read_flax_state,
                     state_from_flax, state_to_flax, train_step, write_flax_state)
from .eval_best import build_pool, score

# DAT-TPU's dilated per-axis taps at levels 3, 2 and 1 (--dilated), and its
# learned offset groups (--goff), as the JAX tool sets them.
OFFSET_SETS = ((-2, -1, 0, 1, 2), (-4, -2, -1, 0, 1, 2, 4), (-6, -4, -2, -1, 0, 1, 2, 4, 6))
OFFSET_GROUPS = (4, 8, 8)


def recover_best(jsonl_path: Path) -> tuple[float, int]:
    """Max held-out PSNR (and its step) over every eval event already in
    the curve: the watermark a resumed run must not regress below."""
    best_psnr, best_step = -1.0, -1
    if jsonl_path.exists():
        for line in jsonl_path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("event") == "eval" and rec.get("val_psnr", -1.0) > best_psnr:
                best_psnr = float(rec["val_psnr"])
                best_step = int(rec["step"])
    return best_psnr, best_step


def batch_sampler(seed: int, pool: int, batch: int, step0: int = 0) -> np.random.Generator:
    """The batch-index generator of the JAX tool, fast-forwarded past the
    ``step0`` batches a resumed run has already taken."""
    sampler = np.random.Generator(np.random.PCG64(seed + 777))
    for _ in range(step0):
        sampler.integers(0, pool, size=batch)
    return sampler


def _ints(text: str | None) -> tuple | None:
    return tuple(int(x) for x in text.split(",")) if text else None


def shared_offsets(args: argparse.Namespace) -> tuple[bool | tuple, str]:
    """The model's ``shared_offsets`` and its part of the tag: per level
    (lv3, lv2, lv1) from ``--shared_levels`` (which overrides
    ``--shared``), else ``--shared`` for every level."""
    if args.shared_levels:
        levels = {int(x) for x in args.shared_levels.split(",")}
        return (tuple(lv in levels for lv in (3, 2, 1)),
                "_shared" + "".join(str(lv) for lv in sorted(levels, reverse=True)))
    return bool(args.shared), "_shared" if args.shared else ""


def result_tag(args: argparse.Namespace) -> str:
    """The JAX tool's tag, part by part in its order."""
    samples, movement_nf = _ints(args.samples), _ints(args.movement_nf)
    return (args.model + ("_dilated" if args.dilated else "") + ("_goff" if args.goff else "")
            + shared_offsets(args)[1]
            + ("_s" + "-".join(map(str, samples)) if samples else "")
            + (f"_stride{args.attn_stride}" if args.attn_stride != 1 else "")
            + ("_mv" + "-".join(map(str, movement_nf)) if movement_nf else "")
            + (f"_dec{args.dec_res_blocks}" if args.dec_res_blocks != 10 else "")
            + ((f"_distill{args.distill_w}"
                + (("T" + "-".join(args.teacher_samples.split(",")))
                   if args.teacher_samples else ""))
               if args.distill_from else "")
            + (f"_nf{args.nf}" if args.nf != 72 else "")
            + (("_rt" + "-".join(x.replace("0.", "") for x in args.random_t.split(",")))
               if args.random_t else "")
            + (f"_seed{args.seed}" if args.seed != 42 else "")
            + (f"_{args.steps // 1000}k" if args.steps != 4000 else "")
            + (args.tag_suffix or ""))


def take_batch(pool: dict, idx: np.ndarray, device: torch.device) -> dict:
    """The batch of pool items ``idx`` on ``device``: gathered on the device
    from a pool of tensors there, or, from a pool of numpy arrays on the
    host (``--host_pool``), gathered on the host and copied over."""
    if isinstance(next(iter(pool.values())), np.ndarray):
        return {k: torch.from_numpy(v[idx]).to(device) for k, v in pool.items()}
    ix = torch.from_numpy(idx).to(device)
    return {k: v.index_select(0, ix) for k, v in pool.items()}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--nf", type=int, default=72)
    ap.add_argument("--pool", type=int, default=768)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--eval_items", type=int, default=32)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=20,
                    help="steps between two reads of the loss on the host")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out_dir>/<tag>.ckpt (the whole TrainState, the "
                         "sampler fast-forwarded)")
    ap.add_argument("--distill_from", default=None,
                    help="a teacher checkpoint (flax msgpack TrainState); adds "
                         "distill_w * Charbonnier(pred - pred_teacher)")
    ap.add_argument("--distill_w", type=float, default=0.5)
    ap.add_argument("--teacher_nf", type=int, default=None,
                    help="teacher width (default: --nf)")
    ap.add_argument("--teacher_shared", action="store_true")
    ap.add_argument("--teacher_samples", default=None,
                    help="teacher per-level samples, e.g. 8,16,8 (default 8,16,32)")
    ap.add_argument("--shared", action="store_true", help="shared offsets at every level")
    ap.add_argument("--dilated", action="store_true",
                    help="DAT-TPU: dilated window taps (OFFSET_SETS)")
    ap.add_argument("--goff", action="store_true",
                    help="DAT-TPU: learned per-group offsets (4, 8, 8 groups)")
    ap.add_argument("--samples", default=None,
                    help="per-level samples 'lv3,lv2,lv1' (default 8,16,32)")
    ap.add_argument("--shared_levels", default=None,
                    help="DAT levels with shared offsets, e.g. '2,1' (overrides --shared)")
    ap.add_argument("--attn_stride", type=int, default=1,
                    help="lv1's query-grid stride (2: a quarter of the finest level's "
                         "queries, a learned upsample back)")
    ap.add_argument("--movement_nf", default=None,
                    help="movement-extractor width per level 'lv3,lv2,lv1' (default: nf)")
    ap.add_argument("--dec_res_blocks", type=int, default=10,
                    help="generator residual blocks")
    ap.add_argument("--random_t", default=None,
                    help="training pool's t range 'lo,hi'; the held-out pool stays at 0.5")
    ap.add_argument("--host_pool", action="store_true",
                    help="keep the pool on the host and copy each batch (the same batches)")
    ap.add_argument("--stop_at", type=int, default=None,
                    help="stop at this step, keeping the --steps schedule")
    ap.add_argument("--tag_suffix", default=None)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.eval_every % args.chunk or args.steps % args.chunk:
        raise SystemExit("--chunk must divide --eval_every and --steps")
    return args


def main(argv: list[str] | None = None) -> dict:
    """Train as the arguments say. Returns the emitted records, the tag, the
    final train state and, on the card, ``ms_per_step`` (CUDA events around
    the training steps after the first chunk, evaluations excluded) and
    ``peak_memory_bytes``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = result_tag(args)
    out_path = out_dir / f"{tag}.jsonl"
    cfg = Config(model_name=args.model, nf=args.nf, compute_dtype="bfloat16", start_lr=2e-4,
                 end_lr=1e-5, last_lr_decay_iter=args.steps, warmup_steps=args.warmup,
                 seed=args.seed, shared_offsets=shared_offsets(args)[0],
                 dat_samples=_ints(args.samples) or (8, 16, 32),
                 dec_res_blocks=args.dec_res_blocks, dat_attn_stride=(1, 1, args.attn_stride),
                 dat_movement_nf=_ints(args.movement_nf),
                 offset_sets=OFFSET_SETS if args.dilated else None,
                 n_offset_groups=OFFSET_GROUPS if args.goff else (0, 0, 0))
    torch.manual_seed(cfg.seed)
    model = create_model(cfg, torch.float32).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(model, cfg)

    crop = (args.crop, args.crop)
    print("generating scene pools ...", flush=True)
    t0 = time.perf_counter()
    random_t = tuple(float(x) for x in args.random_t.split(",")) if args.random_t else False
    pool = build_pool(args.pool, crop, args.seed, is_train=True, random_t=random_t)
    if not args.host_pool:
        pool = {k: torch.from_numpy(v).to(device) for k, v in pool.items()}
    val = build_pool(args.eval_items, crop, args.seed, is_train=False)
    print(f"pools ready ({time.perf_counter() - t0:.0f}s)", flush=True)

    if args.distill_from:
        # The teacher's width, offsets and samples, every other option at
        # its default, as the JAX tool builds it.
        t_cfg = Config(model_name=args.model, nf=args.teacher_nf or args.nf,
                       compute_dtype="bfloat16", shared_offsets=bool(args.teacher_shared),
                       dat_samples=_ints(args.teacher_samples) or (8, 16, 32))
        teacher = load_model(t_cfg, args.distill_from, device=device)
        for p in teacher.parameters():
            p.requires_grad_(False)
        print(f"teacher restored from {args.distill_from} "
              f"(step {int(read_flax_state(args.distill_from)['step'])})", flush=True)
        loss_fn = make_distill_loss_fn(model, teacher, cfg, args.distill_w)
    else:
        loss_fn = make_loss_fn(model, cfg)

    # fp32 evaluation (the framework's convention) over the held-out pool.
    eval_model = create_model(dataclasses.replace(cfg, compute_dtype="float32")).to(device)

    def held_out_psnr() -> float:
        eval_model.load_state_dict(model.state_dict())
        return score(eval_model.eval(), val)["psnr"]

    records = []
    log_f = open(out_path, "a")

    def emit(rec):
        rec["model"] = tag
        log_f.write(json.dumps(rec) + "\n")
        log_f.flush()
        print(rec, flush=True)
        records.append(rec)

    ckpt_path = out_dir / f"{tag}.ckpt"
    best_path = out_dir / f"{tag}.best.ckpt"
    step0 = 0
    best_psnr, best_step = -1.0, -1
    if args.resume and ckpt_path.exists():
        state_from_flax(read_flax_state(ckpt_path), state)
        step0 = state.step
        best_psnr, best_step = recover_best(out_path)
        emit({"event": "resume", "step": step0, "best_psnr": best_psnr,
              "best_step": best_step})
    else:
        emit({"event": "start", "n_params": n_params, "steps": args.steps,
              "batch": args.batch, "crop": args.crop, "pool": args.pool, "chunk": args.chunk})
    sampler = batch_sampler(args.seed, args.pool, args.batch, step0)

    timed = []   # (start, end) CUDA events of every chunk after the first
    run_until = min(args.steps, args.stop_at) if args.stop_at else args.steps
    t_start = time.perf_counter()
    loss_acc, n_acc = 0.0, 0
    step = step0
    try:
        while step < run_until:
            idx = [sampler.integers(0, args.pool, size=args.batch) for _ in range(args.chunk)]
            events = None
            if device.type == "cuda" and step > step0:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            losses = []
            for i in idx:
                losses.append(train_step(state, loss_fn, take_batch(pool, i, device))
                              ["total_loss"])
            if events is not None:
                events[1].record()
                timed.append(events)
            loss_acc += float(torch.stack(losses).sum())
            if step == step0:
                print(f"first chunk done ({time.perf_counter() - t_start:.0f}s incl. "
                      "warm-up)", flush=True)
            step += args.chunk
            n_acc += args.chunk
            if step % args.eval_every == 0 or step >= run_until:
                p = held_out_psnr()
                emit({"event": "eval", "step": step, "train_loss": round(loss_acc / n_acc, 5),
                      "val_psnr": round(p, 4),
                      "elapsed_s": round(time.perf_counter() - t_start, 1)})
                loss_acc, n_acc = 0.0, 0
                write_flax_state(ckpt_path, state_to_flax(state))
                if p > best_psnr:
                    best_psnr, best_step = p, step
                    write_flax_state(best_path, state_to_flax(state))

        final = held_out_psnr()
        emit({"event": "final" if step >= args.steps else "stop", "step": step,
              "val_psnr": round(final, 4), "best_psnr": best_psnr, "best_step": best_step,
              "elapsed_s": round(time.perf_counter() - t_start, 1)})
    finally:
        log_f.close()
    out = {"records": records, "tag": tag, "state": state, "ms_per_step": None,
           "peak_memory_bytes": None}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if timed:
            out["ms_per_step"] = (sum(a.elapsed_time(b) for a, b in timed)
                                  / (len(timed) * args.chunk))
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


if __name__ == "__main__":
    main()
