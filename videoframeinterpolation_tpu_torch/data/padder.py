"""Replicate-pad frames to a multiple of 16 (counterpart of ``videoframeinterpolation_tpu/data/padder.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads NHWC images so H and W are divisible by ``divisor``."""

    def __init__(self, shape, divisor: int = 16):
        self.ht, self.wd = shape[-3], shape[-2]
        pad_ht = (((self.ht // divisor) + 1) * divisor - self.ht) % divisor
        pad_wd = (((self.wd // divisor) + 1) * divisor - self.wd) % divisor
        # (left, right, top, bottom), F.pad's order for the last two dims.
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                     pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        return [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
                .permute(0, 2, 3, 1) for x in inputs]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        ht, wd = x.shape[-3], x.shape[-2]
        l, r, t, b = self._pad
        return x[..., t:ht - b, l:wd - r, :]
