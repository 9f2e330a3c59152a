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

``--tile N`` tiles frames larger than N pixels, in pair mode and in both
sequence modes, with an overlap sized per pair from the model's own flow
estimate (:mod:`.parallel.spatial`): ``make_flow_aware_tiled`` in pair
and recursive mode, ``make_flow_aware_multi_t`` in direct mode (every
instant of a tile decoded from one encoder run), as the JAX CLI does.

Usage::

    python -m videoframeinterpolation_tpu_torch.interpolate [--config DAT_fast] \
        --frame0 a.png --frame1 b.png --out mid.png [--t 0.5] [--tile 512] [--device cuda]
    python -m videoframeinterpolation_tpu_torch.interpolate [--config DAT_fast] \
        --in_dir frames/ --out_dir out/ --factor 4 [--mode recursive|direct] [--tile 512]

Frames are ``(H, W, 3)`` uint8 images of any H and W (they are padded to a
multiple of 16), as 8-bit RGB ``.png`` files (read and written by the
port's own codec, :mod:`.data.png`) or ``.npy`` arrays; a frame is written
in the format its name ends in. In sequence mode the ``.png`` or ``.npy``
files of ``--in_dir`` (one format) are read in sorted order and the output
is written as ``%06d.png`` (``%06d.npy`` for ``.npy`` frames).
``--config`` names a preset of :data:`..config.PRESETS`, whose ``--ckpt``
defaults to its committed checkpoint, or a YAML file of any ported model
(``configs/IFRNet.yaml``, ``configs/DAT_TPU.yaml``, ...), which needs
``--ckpt``: a flax msgpack checkpoint of the config's architecture, such as
the port's trainer writes. IFRNet, DCNDAT and DCNTrans return no
``pred_ft0`` flow pyramid to size the tiles' overlap, so ``--tile`` with
any of them fails before the model runs. (The JAX CLI's probe finds no
``pred_ft0`` either; it warns and tiles with a guessed 32-px overlap,
which may seam where the motion is larger.) None has the staged
``encode``/``decode`` API that ``--mode direct`` runs, so direct mode
refuses them too. DCNTrans v1 does not read ``t``: every instant of a
pair gives the same frame, as in JAX.
``--window_sampling`` sets the config's ``window_sampling``, as the JAX
CLI does: the same function with the same parameters, which the port
computes with the same kernel, so the frames are the same.

:func:`load_model` serves a config in its ``compute_dtype``, as the JAX
CLI does: the presets (their YAMLs) in bf16, a config with
``compute_dtype="float32"`` in fp32. On a CUDA device it switches TF32 off,
process-wide, for cuDNN convolutions and for matmuls, so that an fp32
model computes in full fp32 on the card, as on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from .config import PRESETS, Config
from .data import InputPadder, decode_png, encode_png
from .interop import params_from_flax
from .models import CoarseToFineDAT, create_model, multi_t_apply
from .parallel.spatial import make_flow_aware_multi_t, make_flow_aware_tiled
from .train import read_flax_msgpack

FRAME_SUFFIXES = (".png", ".npy")

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


def config_and_ckpt(config: str, ckpt: str | None):
    """``(config, checkpoint)`` of ``--config`` and ``--ckpt``: a preset and
    its committed checkpoint (or ``ckpt``), or a YAML file and ``ckpt``,
    which it then needs."""
    if config in PRESETS:
        preset = PRESETS[config]
        return preset.config, ckpt or preset.ckpt
    if not ckpt:
        raise SystemExit(f"--config {config}: a YAML file needs --ckpt (a flax msgpack "
                         "checkpoint of its model)")
    return Config.from_yaml(config, exp_name="infer"), ckpt


def read_frame(path: str | Path) -> np.ndarray:
    """A frame from a ``.png`` or ``.npy`` file."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return decode_png(path.read_bytes(), str(path))
    if path.suffix.lower() == ".npy":
        return np.load(path)
    raise SystemExit(f"{path}: frames are .png or .npy files")


def write_frame(path: str | Path, img: np.ndarray) -> None:
    """Write a uint8 frame as ``.png`` or ``.npy``, by the name's suffix."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        path.write_bytes(encode_png(img))
    elif path.suffix.lower() == ".npy":
        np.save(path, img)
    else:
        raise SystemExit(f"{path}: frames are written as .png or .npy files")


def _train_apply(m, a, b, t, train):
    return m(a, b, t, train=train)


def _check_tileable(model: torch.nn.Module) -> None:
    """Flow-aware tiling sizes the overlap from the model's ``train=True``
    flow pyramids (``pred_ft0``), which only the DAT family returns
    (IFRNet and DCNDAT return ``flows0``, DCNTrans its offset flows):
    refuse any other model rather than guess the overlap."""
    if not isinstance(model, CoarseToFineDAT):
        raise ValueError(f"--tile needs a model that returns its flow pyramid (pred_ft0), "
                         f"which sizes the tiles' overlap; {type(model).__name__} returns "
                         "none, so it runs whole frames only (drop --tile)")


def make_infer(model: torch.nn.Module, tile: int = 0):
    """``infer(x0, x1, t)``: the model's forward, or with ``tile`` its
    flow-aware tiled forward (:func:`..parallel.spatial.make_flow_aware_tiled`,
    probed through the model's ``train=True`` flow pyramids; a model
    without them raises)."""
    if not tile:
        return model
    _check_tileable(model)
    return make_flow_aware_tiled(lambda m, a, b, t: m(a, b, t), model, tile,
                                 train_apply_fn=_train_apply)


def make_multi_infer(model: torch.nn.Module, ts, tile: int = 0):
    """``multi_infer(x0, x1) -> (len(ts), B, H, W, 3)`` through
    :func:`..models.multi_t_apply`, with ``tile`` flow-aware and tiled
    (:func:`..parallel.spatial.make_flow_aware_multi_t`)."""
    if not tile:
        return lambda a, b: multi_t_apply(model, a, b, ts)
    _check_tileable(model)
    return make_flow_aware_multi_t(lambda m, a, b: multi_t_apply(m, a, b, ts), model, tile, ts,
                                   train_apply_fn=_train_apply)


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
                t: float = 0.5, infer=None) -> np.ndarray:
    """One ``(H, W, 3)`` uint8 frame at instant ``t`` between two: pad to a
    multiple of 16, infer (``model``'s forward, or ``infer(x0, x1, t)``
    such as :func:`make_infer` gives), unpad, and quantise as the JAX CLI
    does."""
    x0p, x1p, padder = _padded_pair(model, img0, img1)
    tt = torch.full((1, 1, 1, 1), t, dtype=torch.float32, device=x0p.device)
    return _to_uint8(padder.unpad((infer or model)(x0p, x1p, tt))[0])


@torch.inference_mode()
def interp_pair_direct(model: torch.nn.Module, img0: np.ndarray, img1: np.ndarray,
                       ts, multi_infer=None) -> list[np.ndarray]:
    """The uint8 frames at every instant of ``ts`` between two, the
    encoder run once (:func:`..models.multi_t_apply`, or ``multi_infer``
    such as :func:`make_multi_infer` gives)."""
    x0p, x1p, padder = _padded_pair(model, img0, img1)
    preds = (multi_infer or make_multi_infer(model, ts))(x0p, x1p)   # (len(ts), 1, Hp, Wp, 3)
    return [_to_uint8(padder.unpad(p)[0]) for p in preds]


def upsample_sequence(model: torch.nn.Module, seq: list[np.ndarray], factor: int,
                      mode: str = "recursive", tile: int = 0) -> list[np.ndarray]:
    """``seq`` with ``factor - 1`` frames inserted between each pair:
    ``(len(seq) - 1) * factor + 1`` frames. ``recursive`` runs ``log2
    factor`` levels of t = 0.5 over the growing sequence (``factor`` a
    power of two); ``direct`` decodes the instants ``(i+1)/factor`` from
    each original pair, the encoder run once per pair. ``tile`` tiles
    large frames (:func:`make_infer`, :func:`make_multi_infer`)."""
    if mode == "direct":
        ts = tuple((i + 1) / factor for i in range(factor - 1))
        multi_infer = make_multi_infer(model, ts, tile)
        out = []
        for a, b in zip(seq[:-1], seq[1:]):
            out.append(a)
            out.extend(interp_pair_direct(model, a, b, ts, multi_infer))
        out.append(seq[-1])
        return out
    if mode != "recursive":
        raise ValueError(f"unknown mode {mode!r}; expected 'recursive' or 'direct'")
    infer = make_infer(model, tile)
    for _ in range(int(np.log2(factor))):
        out = []
        for a, b in zip(seq[:-1], seq[1:]):
            out.append(a)
            out.append(interp_pair(model, a, b, 0.5, infer))
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
    parser.add_argument("--config", default="DAT_fast",
                        help=f"a preset ({', '.join(sorted(PRESETS))}) or a YAML file")
    parser.add_argument("--ckpt", default=None,
                        help="flax msgpack checkpoint (default: the preset's; required with "
                             "a YAML file)")
    parser.add_argument("--frame0", help="pair mode: an RGB .png or (H, W, 3) uint8 .npy")
    parser.add_argument("--frame1", help="pair mode: an RGB .png or (H, W, 3) uint8 .npy")
    parser.add_argument("--out", help="pair mode: output .png or .npy")
    parser.add_argument("--t", type=float, default=0.5)
    parser.add_argument("--in_dir", help="sequence mode: dir of RGB .png or (H, W, 3) uint8 "
                                         ".npy frames")
    parser.add_argument("--out_dir", help="sequence mode: output dir")
    parser.add_argument("--factor", type=int, default=2,
                        help="sequence mode: frame-rate multiplier "
                             "(recursive mode: power of 2; direct: any)")
    parser.add_argument("--mode", choices=["recursive", "direct"], default="recursive",
                        help="sequence upsampling strategy. recursive: t=0.5 halving "
                             "levels (later levels interpolate generated frames). "
                             "direct: all factor-1 instants from the ORIGINAL pair, "
                             "the t-invariant encoder run once per pair")
    parser.add_argument("--window_sampling", action="store_true",
                        help="the config's window_sampling: the same function and parameters "
                             "(any flagship checkpoint works)")
    parser.add_argument("--tile", type=int, default=0,
                        help="spatial tile size for HD inputs (0 = off)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    # cheap argument validation before the (slow) model load
    cfg, ckpt = config_and_ckpt(args.config, args.ckpt)
    if args.window_sampling:
        cfg = dataclasses.replace(cfg, window_sampling=True)
    if args.in_dir:
        if args.mode == "recursive" and args.factor & (args.factor - 1):
            raise SystemExit("--mode recursive needs a power-of-2 --factor; "
                             f"use --mode direct for factor {args.factor}")
        if args.mode == "direct" and args.factor < 2:
            raise SystemExit("--mode direct needs --factor >= 2 "
                             "(factor 1 inserts no frames)")
        frames = sorted(p for p in Path(args.in_dir).iterdir()
                        if p.suffix.lower() in FRAME_SUFFIXES)
        suffixes = {p.suffix.lower() for p in frames}
        if len(suffixes) > 1:
            raise SystemExit(f"--in_dir {args.in_dir}: mixes .png and .npy frames")
        if len(frames) < 2:
            raise SystemExit(f"--in_dir {args.in_dir}: needs at least 2 .png or .npy frames, "
                             f"found {len(frames)}")
        seq = [read_frame(f) for f in frames]
        _check_frames([(str(f), img) for f, img in zip(frames, seq)])
    elif not (args.frame0 and args.frame1 and args.out):
        raise SystemExit("pair mode needs --frame0, --frame1 and --out "
                         "(or --in_dir for sequence mode)")
    else:
        img0, img1 = read_frame(args.frame0), read_frame(args.frame1)
        _check_frames([("--frame0", img0), ("--frame1", img1)])

    model = load_model(cfg, ckpt, device=args.device)
    try:
        infer = make_infer(model, args.tile)
    except ValueError as e:
        raise SystemExit(f"--config {args.config}: {e}") from None
    if args.in_dir:
        out_dir = Path(args.out_dir or "interp_out")
        out_dir.mkdir(parents=True, exist_ok=True)
        seq = upsample_sequence(model, seq, args.factor, args.mode, args.tile)
        suffix = frames[0].suffix.lower()
        for i, fr in enumerate(seq):
            write_frame(out_dir / f"{i:06d}{suffix}", fr)
        print(f"wrote {len(seq)} frames to {out_dir}")
    else:
        write_frame(args.out, interp_pair(model, img0, img1, args.t, infer))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
