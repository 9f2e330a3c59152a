"""Serving entry point: interpolate between two frames, or upsample a sequence.

Counterpart of the JAX CLI (``interpolate.py``): pair mode, and sequence
mode with ``--factor N``, recursive (``log2 N`` levels of t = 0.5) or
``--mode direct`` (every instant ``(i+1)/N`` from the original pair, the
encoder run once per pair through :func:`..models.multi_t_apply`; any
integer factor of at least 2).

Quality guidance for off-center instants (measured on the TPU for the JAX
package, ``BENCH_NOTES.md`` round-5 per-instant table): checkpoints trained
at the reference's fixed t = 0.5 degrade symmetrically away from the
center, by -10 dB PSNR at t = 1/8 and 7/8 on the factor-8 grid, so
``--mode direct`` with the shipped recipe is only quality-validated at
t = 0.5. For direct multi-instant serving, train with ``random_t``
spanning the served grid (e.g. ``tools/quality/head_to_head.py --random_t
0.125,0.875``), which costs about 2 dB at the center instant but covers
the grid; otherwise prefer the default recursive mode, which decodes
every frame at the validated t = 0.5.

Usage::

    python -m videoframeinterpolation_tpu_torch.interpolate [--config DAT_fast] \
        --frame0 a.npy --frame1 b.npy --out mid.npy [--t 0.5] [--device cuda]
    python -m videoframeinterpolation_tpu_torch.interpolate [--config DAT_fast] \
        --in_dir frames/ --out_dir out/ --factor 4 [--mode recursive|direct]

Frames are ``(H, W, 3)`` uint8 ``.npy`` arrays of any H and W (they are
padded to a multiple of 16). In sequence mode the ``.npy`` files of
``--in_dir`` are read in sorted order and the output is written as
``%06d.npy``. ``--config`` names a preset of :data:`..config.PRESETS`;
``--ckpt`` defaults to its committed checkpoint, and may name another flax
msgpack checkpoint of the same architecture.

:func:`load_model` serves a config in its ``compute_dtype``, as the JAX
CLI does: the presets (their YAMLs) in bf16, a config with
``compute_dtype="float32"`` in fp32. On a CUDA device it switches TF32 off,
process-wide, for cuDNN convolutions and for matmuls, so that an fp32
model computes in full fp32 on the card, as on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .config import PRESETS, Config
from .data import InputPadder
from .interop import params_from_flax
from .models import create_model, multi_t_apply
from .train import read_flax_msgpack

SHIPPED_STUDENT = PRESETS["DAT_fast"].ckpt


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; CUDA raises when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was requested but no CUDA device is available")
    return device


def load_model(cfg: Config, ckpt: str | Path, device: str = "cuda") -> torch.nn.Module:
    """Build ``cfg``'s model in ``cfg.compute_dtype``, load a flax msgpack
    checkpoint into it and put it on ``device`` in eval mode. On CUDA this
    switches TF32 off (see the module docstring)."""
    device = resolve_device(device)
    model = create_model(cfg)
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(device).eval()


def _to_uint8(pred: torch.Tensor) -> np.ndarray:
    """Quantise one ``(H, W, 3)`` frame in [0, 1] as the JAX CLI does."""
    return (np.clip(pred.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def _padded_pair(model: torch.nn.Module, img0: np.ndarray, img1: np.ndarray):
    """Both frames as ``(1, H, W, 3)`` fp32 on the model's device, padded to
    a multiple of 16, and the padder that undoes it."""
    device = next(model.parameters()).device
    x0 = torch.from_numpy(img0.astype(np.float32) / 255.0)[None].to(device)
    x1 = torch.from_numpy(img1.astype(np.float32) / 255.0)[None].to(device)
    padder = InputPadder(x0.shape, divisor=16)
    x0p, x1p = padder.pad(x0, x1)
    return x0p, x1p, padder


@torch.inference_mode()
def interp_pair(model: torch.nn.Module, img0: np.ndarray, img1: np.ndarray,
                t: float = 0.5) -> np.ndarray:
    """One ``(H, W, 3)`` uint8 frame at instant ``t`` between two: pad to a
    multiple of 16, infer, unpad, and quantise as the JAX CLI does."""
    x0p, x1p, padder = _padded_pair(model, img0, img1)
    tt = torch.full((1, 1, 1, 1), t, dtype=torch.float32, device=x0p.device)
    return _to_uint8(padder.unpad(model(x0p, x1p, tt))[0])


@torch.inference_mode()
def interp_pair_direct(model: torch.nn.Module, img0: np.ndarray, img1: np.ndarray,
                       ts) -> list[np.ndarray]:
    """The uint8 frames at every instant of ``ts`` between two, the
    encoder run once (:func:`..models.multi_t_apply`)."""
    x0p, x1p, padder = _padded_pair(model, img0, img1)
    preds = multi_t_apply(model, x0p, x1p, ts)   # (len(ts), 1, Hp, Wp, 3)
    return [_to_uint8(padder.unpad(p)[0]) for p in preds]


def upsample_sequence(model: torch.nn.Module, seq: list[np.ndarray], factor: int,
                      mode: str = "recursive") -> list[np.ndarray]:
    """``seq`` with ``factor - 1`` frames inserted between each pair:
    ``(len(seq) - 1) * factor + 1`` frames. ``recursive`` runs ``log2
    factor`` levels of t = 0.5 over the growing sequence (``factor`` a
    power of two); ``direct`` decodes the instants ``(i+1)/factor`` from
    each original pair, the encoder run once per pair."""
    if mode == "direct":
        ts = tuple((i + 1) / factor for i in range(factor - 1))
        out = []
        for a, b in zip(seq[:-1], seq[1:]):
            out.append(a)
            out.extend(interp_pair_direct(model, a, b, ts))
        out.append(seq[-1])
        return out
    if mode != "recursive":
        raise ValueError(f"unknown mode {mode!r}; expected 'recursive' or 'direct'")
    for _ in range(int(np.log2(factor))):
        out = []
        for a, b in zip(seq[:-1], seq[1:]):
            out.append(a)
            out.append(interp_pair(model, a, b, 0.5))
        out.append(seq[-1])
        seq = out
    return seq


def _check_frames(named: list[tuple[str, np.ndarray]]) -> None:
    for name, img in named:
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise SystemExit(f"{name}: expected an (H, W, 3) uint8 array, got "
                             f"{img.dtype} {img.shape}")
    shapes = {img.shape for _, img in named}
    if len(shapes) > 1:
        raise SystemExit(f"frame shapes differ: {sorted(shapes)}")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA VFI inference")
    parser.add_argument("--config", choices=sorted(PRESETS), default="DAT_fast")
    parser.add_argument("--ckpt", default=None,
                        help="flax msgpack checkpoint (default: the preset's)")
    parser.add_argument("--frame0", help="pair mode: (H, W, 3) uint8 .npy")
    parser.add_argument("--frame1", help="pair mode: (H, W, 3) uint8 .npy")
    parser.add_argument("--out", help="pair mode: output .npy")
    parser.add_argument("--t", type=float, default=0.5)
    parser.add_argument("--in_dir", help="sequence mode: dir of (H, W, 3) uint8 .npy frames")
    parser.add_argument("--out_dir", help="sequence mode: output dir")
    parser.add_argument("--factor", type=int, default=2,
                        help="sequence mode: frame-rate multiplier "
                             "(recursive mode: power of 2; direct: any)")
    parser.add_argument("--mode", choices=["recursive", "direct"], default="recursive",
                        help="sequence upsampling strategy. recursive: t=0.5 halving "
                             "levels (later levels interpolate generated frames). "
                             "direct: all factor-1 instants from the ORIGINAL pair, "
                             "the t-invariant encoder run once per pair")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    # cheap argument validation before the (slow) model load
    if args.in_dir:
        if args.mode == "recursive" and args.factor & (args.factor - 1):
            raise SystemExit("--mode recursive needs a power-of-2 --factor; "
                             f"use --mode direct for factor {args.factor}")
        if args.mode == "direct" and args.factor < 2:
            raise SystemExit("--mode direct needs --factor >= 2 "
                             "(factor 1 inserts no frames)")
        frames = sorted(p for p in Path(args.in_dir).iterdir() if p.suffix == ".npy")
        seq = [np.load(f) for f in frames]
        if len(seq) < 2:
            raise SystemExit(f"--in_dir {args.in_dir}: needs at least 2 .npy frames, "
                             f"found {len(seq)}")
        _check_frames([(str(f), img) for f, img in zip(frames, seq)])
    elif not (args.frame0 and args.frame1 and args.out):
        raise SystemExit("pair mode needs --frame0, --frame1 and --out "
                         "(or --in_dir for sequence mode)")
    else:
        img0, img1 = np.load(args.frame0), np.load(args.frame1)
        _check_frames([("--frame0", img0), ("--frame1", img1)])

    preset = PRESETS[args.config]
    model = load_model(preset.config, args.ckpt or preset.ckpt, device=args.device)
    if args.in_dir:
        out_dir = Path(args.out_dir or "interp_out")
        out_dir.mkdir(parents=True, exist_ok=True)
        seq = upsample_sequence(model, seq, args.factor, args.mode)
        for i, fr in enumerate(seq):
            np.save(out_dir / f"{i:06d}.npy", fr)
        print(f"wrote {len(seq)} frames to {out_dir}")
    else:
        np.save(args.out, interp_pair(model, img0, img1, args.t))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
