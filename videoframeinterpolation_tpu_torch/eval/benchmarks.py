"""Validation loops (counterpart of ``videoframeinterpolation_tpu/eval/benchmarks.py``).

Vimeo90K, UCF101, the procedural synthetic pool and SNU-FILM. Each loop
takes ``infer(x0, x1, t) -> pred`` on NHWC [0, 1] fp32 tensors on
``device`` (the model's), scores each item's prediction there with
:func:`..eval.psnr` and, with ``report_ssim``, :func:`..eval.ssim_3d`
(dynamic range read off the prediction), and returns the mean over items
under the JAX loop's keys, printing the JAX loop's lines.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..data import DataLoader, InputPadder, Vimeo90K
from ..data.readers import read_image
from .metrics import psnr, ssim_3d


def _scores(pred: torch.Tensor, gt: torch.Tensor, report_ssim: bool, psnrs: list,
            ssims: list) -> None:
    """Append each item's PSNR (and SSIM) of ``pred`` against ``gt``."""
    for i in range(pred.shape[0]):
        psnrs.append(float(psnr(pred[i], gt[i])))
        if report_ssim:
            ssims.append(float(ssim_3d(pred[i:i + 1], gt[i:i + 1])))


def _result(prefix: str, name: str, psnrs: list, ssims: list, report_ssim: bool) -> dict:
    results = {f"val/{prefix}_psnr": float(np.mean(psnrs))}
    log = f"Validation {name} PSNR: {results[f'val/{prefix}_psnr']:.4f}"
    if report_ssim:
        results[f"val/{prefix}_ssim"] = float(np.mean(ssims))
        log += f", SSIM: {results[f'val/{prefix}_ssim']:.4f}"
    print(log)
    return results


def _on(device, *arrays: np.ndarray) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@torch.inference_mode()
def validate_vimeo90k(infer: Callable, root: str, batch_size: int = 4,
                      report_ssim: bool = False, num_workers: int = 8,
                      device: str | torch.device = "cpu") -> dict:
    """Per-image PSNR over the Vimeo90K test split (``evaluate.py:88-124``)."""
    ds = Vimeo90K(root, is_train=False)
    loader = DataLoader(ds, batch_size, shuffle=False, drop_last=False,
                        num_workers=num_workers)
    print(f"Number of validation images: {len(ds)}")
    psnrs, ssims = [], []
    for batch in loader:
        x0, x1, t, gt = _on(device, batch["x0"], batch["x1"], batch["t"], batch["xt"])
        _scores(infer(x0, x1, t), gt, report_ssim, psnrs, ssims)
    return _result("vimeo90k", "Vimeo90K", psnrs, ssims, report_ssim)


@torch.inference_mode()
def validate_ucf101(infer: Callable, root: str = "datasets/UCF-101/test",
                    report_ssim: bool = False, device: str | torch.device = "cpu") -> dict:
    """Directory-walk evaluation (``evaluate.py:127-160``)."""
    dirs = sorted(os.listdir(root))
    print(f"Number of validation images: {len(dirs)}")
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    psnrs, ssims = [], []
    for d in dirs:
        base = Path(root) / d
        img0, img1, gt = (read_image(str(base / n)).astype(np.float32)[None] / 255.0
                          for n in ("frame_00.png", "frame_02.png", "frame_01_gt.png"))
        x0, x1, tt, gt = _on(device, img0, img1, t, gt)
        _scores(infer(x0, x1, tt), gt, report_ssim, psnrs, ssims)
    return _result("ucf101", "UCF101", psnrs, ssims, report_ssim)


@torch.inference_mode()
def validate_synthetic(infer: Callable, seed: int = 42, num_items: int = 64,
                       hw: tuple[int, int] = (256, 448), batch_size: int = 4,
                       report_ssim: bool = False, device: str | torch.device = "cpu") -> dict:
    """Held-out PSNR on the procedural-motion generator: ``num_items``
    scenes of the held-out split at ``hw``, in batches of ``batch_size``."""
    from ..data.synthetic import SyntheticMotion

    ds = SyntheticMotion(crop_hw=hw, is_train=False, seed=seed, num_items=num_items)
    psnrs, ssims = [], []
    for start in range(0, num_items, batch_size):
        items = [ds[i] for i in range(start, min(start + batch_size, num_items))]
        x0, x1, t, gt = _on(device, *(np.stack([it[k] for it in items])
                                      for k in ("x0", "x1", "t", "xt")))
        _scores(infer(x0, x1, t), gt, report_ssim, psnrs, ssims)
    return _result("synthetic", "Synthetic", psnrs, ssims, report_ssim)


def _fix_snu_prefix(p: str) -> str:
    """SNU-FILM list files name frames under ``data/SNU-FILM/...``; this
    repo keeps them under ``datasets/``. Only the leading path component is
    remapped, and the path stays relative to the working directory."""
    return "datasets/" + p[len("data/"):] if p.startswith("data/") else p


SNU_LEVELS = ("test-easy.txt", "test-medium.txt", "test-hard.txt", "test-extreme.txt")


@torch.inference_mode()
def validate_snu(infer: Callable, root: str = "datasets/SNU-FILM", report_ssim: bool = False,
                 device: str | torch.device = "cpu") -> dict:
    """SNU-FILM easy/medium/hard/extreme, each frame padded to a multiple of
    16 by :class:`..data.InputPadder` and the prediction unpadded
    (``evaluate.py:163-210``)."""
    results = {}
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    for test_file in SNU_LEVELS:
        psnrs, ssims = [], []
        with open(Path(root) / test_file) as f:
            file_list = [line.strip().split(" ") for line in f if line.strip()]
        for paths in file_list:
            i0, gt, i1 = (read_image(_fix_snu_prefix(p)).astype(np.float32)[None] / 255.0
                          for p in paths[:3])
            i0, i1, tt, gt = _on(device, i0, i1, t, gt)
            padder = InputPadder(i0.shape, divisor=16)
            i0p, i1p = padder.pad(i0, i1)
            _scores(padder.unpad(infer(i0p, i1p, tt)), gt, report_ssim, psnrs, ssims)
        name = test_file[:-4]
        results.update(_result(f"snu_{name}", f"SNU-FILM {name}", psnrs, ssims, report_ssim))
    return results
