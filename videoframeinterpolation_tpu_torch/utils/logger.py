"""Training logger (counterpart of ``videoframeinterpolation_tpu/utils/logger.py``).

Running means of the scalars, flushed every ``metric_summary_freq`` steps
with the line ``Step: %06d \t total: %.3f``; dict writes with the tag
namespacing of the reference (``val/vimeo90k_psnr`` is written as
``val/vimeo90k/val/vimeo90k_psnr``); image panels as PNG files under
``<log_dir>/images`` (by the port's codec). Every scalar write is one line
of ``<log_dir>/metrics.jsonl``: ``{"step", "time", "<tag>": value, ...}``.
TensorBoard gets the same where ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..data.png import encode_png


def _try_tensorboard(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:   # no tensorboard package: JSONL and PNG only
        return None


class Logger:
    def __init__(self, log_dir: str, metric_summary_freq: int = 100, start_step: int = 0):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.metric_summary_freq = metric_summary_freq
        self.total_steps = start_step
        self.running: dict[str, float] = {}
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = _try_tensorboard(str(self.log_dir))

    def push(self, metrics: dict, mode: str = "train") -> None:
        """Accumulate running means; flush every ``metric_summary_freq``
        steps (reference ``Logger.push``, ``utils/logger.py:23-35``)."""
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % self.metric_summary_freq == 0:
            means = {k: v / self.metric_summary_freq for k, v in self.running.items()}
            total = means.get("total_loss", float("nan"))
            print(f"Step: {self.total_steps:06d} \t total: {total:.3f}")
            self._write_scalars({f"{mode}/{k}": v for k, v in means.items()}, self.total_steps)
            self.running = {}

    def write_dict(self, results: dict, step: int | None = None) -> None:
        """Namespaced scalar writes (reference ``utils/logger.py:37-43``)."""
        log_step = step if step is not None else self.total_steps
        tagged = {f"{key.split('_')[0]}/{key}": float(v) for key, v in results.items()}
        self._write_scalars(tagged, log_step)

    def add_image_summary(self, img_dict: dict) -> None:
        """Save HWC [0, 1] float or uint8 images."""
        img_dir = self.log_dir / "images"
        img_dir.mkdir(exist_ok=True)
        for k, v in img_dict.items():
            arr = np.asarray(v)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            (img_dir / f"{k}_{self.total_steps:07d}.png").write_bytes(encode_png(arr))
            if self._tb is not None:
                self._tb.add_image(k, arr, self.total_steps, dataformats="HWC")

    def _write_scalars(self, scalars: dict, step: int) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
