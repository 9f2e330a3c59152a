"""Serving entry point: interpolate one frame between two (counterpart of ``interpolate.py:39-101``).

Usage::

    python -m videoframeinterpolation_tpu_torch.interpolate \
        --frame0 a.npy --frame1 b.npy --out mid.npy [--t 0.5] [--device cuda]

Frames are ``(H, W, 3)`` uint8 ``.npy`` arrays; any H and W (they are padded
to a multiple of 16). The model is the ``DAT_fast`` flagship with the
shipped distilled student's weights unless ``--ckpt`` names another flax
msgpack checkpoint of the same architecture.

:func:`load_model` serves a config in its ``compute_dtype``, as the JAX
CLI does: ``DAT_fast`` (``configs/DAT_fast.yaml``) in bf16, a config with
``compute_dtype="float32"`` in fp32. On a CUDA device it switches TF32 off,
process-wide, for cuDNN convolutions and for matmuls, so that an fp32
model computes in full fp32 on the card, as on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .config import DAT_fast, Config
from .data import InputPadder
from .interop import params_from_flax
from .models import create_model
from .train import read_flax_msgpack

REPO_ROOT = Path(__file__).resolve().parent.parent
SHIPPED_STUDENT = (REPO_ROOT / "tools" / "quality" / "results" /
                   "DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.best.ckpt")


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


@torch.inference_mode()
def interp_pair(model: torch.nn.Module, img0: np.ndarray, img1: np.ndarray,
                t: float = 0.5) -> np.ndarray:
    """One ``(H, W, 3)`` uint8 frame at instant ``t`` between two: pad to a
    multiple of 16, infer, unpad, and quantise as the JAX CLI does."""
    device = next(model.parameters()).device
    x0 = torch.from_numpy(img0.astype(np.float32) / 255.0)[None].to(device)
    x1 = torch.from_numpy(img1.astype(np.float32) / 255.0)[None].to(device)
    tt = torch.full((1, 1, 1, 1), t, dtype=torch.float32, device=device)
    padder = InputPadder(x0.shape, divisor=16)
    x0p, x1p = padder.pad(x0, x1)
    pred = padder.unpad(model(x0p, x1p, tt))
    return (np.clip(pred[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA VFI inference")
    parser.add_argument("--ckpt", default=str(SHIPPED_STUDENT))
    parser.add_argument("--frame0", required=True, help="(H, W, 3) uint8 .npy")
    parser.add_argument("--frame1", required=True, help="(H, W, 3) uint8 .npy")
    parser.add_argument("--out", required=True, help="output .npy")
    parser.add_argument("--t", type=float, default=0.5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    img0, img1 = np.load(args.frame0), np.load(args.frame1)
    for name, img in (("frame0", img0), ("frame1", img1)):
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise SystemExit(f"--{name}: expected an (H, W, 3) uint8 array, got "
                             f"{img.dtype} {img.shape}")
    if img0.shape != img1.shape:
        raise SystemExit(f"frame shapes differ: {img0.shape} vs {img1.shape}")
    model = load_model(DAT_fast, args.ckpt, device=args.device)
    np.save(args.out, interp_pair(model, img0, img1, args.t))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
