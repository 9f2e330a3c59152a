"""The Vimeo90K triplet test split (counterpart of ``videoframeinterpolation_tpu/data/vimeo90k.py``).

Only the evaluation split is ported: :class:`Vimeo90K` with
``is_train=False`` reads each triplet of ``tri_testlist.txt`` as
``im1.png``, ``im2.png``, ``im3.png`` in [0, 1]. The training split (its
augmentation and temporal swap) and ``Vimeo90KwFlow`` come with the
production trainer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .readers import read_image

_TRAIN_SPLIT = ("the Vimeo90K training split is not ported yet; it comes with the "
                "production trainer (ROADMAP.md, queue 1 item 5)")


def _read_list(root: str, is_train: bool) -> list[str]:
    name = "tri_trainlist.txt" if is_train else "tri_testlist.txt"
    out = []
    with open(Path(root) / name, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line)
    return out


class Vimeo90K:
    """Triplet dataset without flow; the test split only."""

    def __init__(self, root: str, crop_hw: tuple[int, int] = (256, 256),
                 is_train: bool = True, seed: int = 0):
        if is_train:
            raise NotImplementedError(_TRAIN_SPLIT)
        self.root = root
        self.crop_hw = crop_hw
        self.is_train = is_train
        self.sequences = _read_list(root, is_train)

    def __len__(self) -> int:
        return len(self.sequences)

    def _seq_dir(self, idx: int) -> Path:
        return Path(self.root) / "sequences" / self.sequences[idx]

    def _test_item(self, idx: int) -> dict:
        d = self._seq_dir(idx)
        x0 = read_image(str(d / "im1.png")).astype(np.float32) / 255.0
        xt = read_image(str(d / "im2.png")).astype(np.float32) / 255.0
        x1 = read_image(str(d / "im3.png")).astype(np.float32) / 255.0
        return {"x0": x0, "x1": x1, "xt": xt, "t": np.full((1, 1, 1), 0.5, np.float32)}

    def __getitem__(self, idx: int) -> dict:
        return self._test_item(idx)


class Vimeo90KwFlow(Vimeo90K):
    """Triplets with pseudo-GT flows for distillation: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_TRAIN_SPLIT)
