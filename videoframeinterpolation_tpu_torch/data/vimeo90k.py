"""Vimeo90K triplet datasets (counterpart of ``videoframeinterpolation_tpu/data/vimeo90k.py``).

Training items take the temporal-order augmentation (a random swap of x0
and x1, with the matching swap of the pseudo-GT flows) and the geometric
pipeline, then divide the images by 255 and, unless ``flow_in_pixels``,
the flows too: the reference's unit quirk (``data/Vimeo90K.py:100``
scales the pseudo-GT flows by 1/255), kept because the flagship's
distillation loss was tuned against it.

Two pseudo-GT flow sources: ``distill_bwd=True`` reads ``flow_t0.flo`` /
``flow_t1.flo``, ``False`` reads ``flow_01.npy`` / ``flow_10.npy``.

As in the JAX package, the two classes draw the swap with opposite
senses: :class:`Vimeo90K` takes ``im1`` as x0 when ``integers(0, 2)`` is
1, :class:`Vimeo90KwFlow` swaps when it is 0. Each dataset has one
generator, re-seeded by :meth:`Vimeo90K.seed` (the trainer seeds it per
epoch) and shared by the loader's worker threads, so with more than one
worker the order in which threads draw decides each item's augmentation:
a run is reproducible only with ``num_workers=1``, in both frameworks.

:class:`Vimeo90KwFlow` augments through the native library
(:mod:`.native`) by default, as the JAX package does whenever that library
loads; a failed build raises. ``use_native=False`` selects the numpy path,
which differs on the 10% of items that are upscaled: the native path
truncates the upscaled images to uint8, the numpy path keeps floats.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .augment import random_augment, resize2x
from .native import augment_triplet_native, load_library
from .readers import read, read_image


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
    """Triplet dataset without flow (evaluation, and training without
    distillation)."""

    def __init__(self, root: str, crop_hw: tuple[int, int] = (256, 256),
                 is_train: bool = True, seed: int = 0):
        self.root = root
        self.crop_hw = crop_hw
        self.is_train = is_train
        self.sequences = _read_list(root, is_train)
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def __len__(self) -> int:
        return len(self.sequences)

    def seed(self, seed: int) -> None:
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def _seq_dir(self, idx: int) -> Path:
        return Path(self.root) / "sequences" / self.sequences[idx]

    def _train_item(self, idx: int) -> dict:
        d = self._seq_dir(idx)
        if self._rng.integers(0, 2):
            p0, p1 = d / "im1.png", d / "im3.png"
        else:
            p0, p1 = d / "im3.png", d / "im1.png"
        x0 = read_image(str(p0))
        x1 = read_image(str(p1))
        xt = read_image(str(d / "im2.png"))
        frames = np.concatenate([x0, x1, xt], axis=2).astype(np.float32)
        frames = random_augment(self._rng, frames, self.crop_hw, with_flow=False)
        frames = frames / 255.0
        return {"x0": frames[:, :, 0:3], "x1": frames[:, :, 3:6], "xt": frames[:, :, 6:9],
                "t": np.full((1, 1, 1), 0.5, np.float32)}

    def _test_item(self, idx: int) -> dict:
        d = self._seq_dir(idx)
        x0 = read_image(str(d / "im1.png")).astype(np.float32) / 255.0
        xt = read_image(str(d / "im2.png")).astype(np.float32) / 255.0
        x1 = read_image(str(d / "im3.png")).astype(np.float32) / 255.0
        return {"x0": x0, "x1": x1, "xt": xt, "t": np.full((1, 1, 1), 0.5, np.float32)}

    def __getitem__(self, idx: int) -> dict:
        return self._train_item(idx) if self.is_train else self._test_item(idx)


class Vimeo90KwFlow(Vimeo90K):
    """Triplet dataset with pseudo-GT flows for distillation."""

    def __init__(self, root: str, flow_dir: str = "flow", distill_bwd: bool = True,
                 crop_hw: tuple[int, int] = (256, 256), is_train: bool = True, seed: int = 0,
                 flow_in_pixels: bool = False, use_native: bool = True):
        super().__init__(root, crop_hw, is_train, seed)
        self.flow_dir = flow_dir
        self.distill_bwd = distill_bwd
        self.flow_in_pixels = flow_in_pixels
        self.use_native = use_native
        if use_native:
            load_library()

    def _flow_paths(self, idx: int, swapped: bool) -> tuple[str, str]:
        d = Path(self.root) / self.flow_dir / self.sequences[idx]
        if self.distill_bwd:
            a, b = "flow_t0.flo", "flow_t1.flo"
        else:
            a, b = "flow_01.npy", "flow_10.npy"
        if swapped:
            a, b = b, a
        return str(d / a), str(d / b)

    def _train_item(self, idx: int) -> dict:
        d = self._seq_dir(idx)
        swapped = not self._rng.integers(0, 2)
        if not swapped:
            p0, p1 = d / "im1.png", d / "im3.png"
        else:
            p0, p1 = d / "im3.png", d / "im1.png"
        fa, fb = self._flow_paths(idx, swapped)
        x0 = read_image(str(p0))
        x1 = read_image(str(p1))
        xt = read_image(str(d / "im2.png"))
        f0x = read(fa)
        f1x = read(fb)
        flow_scale = 1.0 if self.flow_in_pixels else 1.0 / 255.0

        if self.use_native and x0.dtype == np.uint8:
            rng = self._rng
            if rng.uniform() < 0.1:
                stack = resize2x(np.concatenate(
                    [x0.astype(np.float32), x1.astype(np.float32), xt.astype(np.float32),
                     f0x, f1x], axis=2), with_flow=True)
                x0 = stack[:, :, 0:3].astype(np.uint8)
                x1 = stack[:, :, 3:6].astype(np.uint8)
                xt = stack[:, :, 6:9].astype(np.uint8)
                f0x, f1x = stack[:, :, 9:11], stack[:, :, 11:13]
            h, w, _ = x0.shape
            ch, cw = self.crop_hw
            frames = augment_triplet_native(
                np.ascontiguousarray(x0), np.ascontiguousarray(x1), np.ascontiguousarray(xt),
                f0x, f1x, crop_hw=self.crop_hw,
                h_off=int(rng.integers(0, h - ch + 1)),
                w_off=int(rng.integers(0, w - cw + 1)),
                chan_reverse=rng.uniform() < 0.5,
                vflip=rng.uniform() < 0.5,
                hflip=rng.uniform() < 0.5,
                rot=int(rng.integers(0, 4)),
                img_scale=1.0 / 255.0,
                flow_scale=flow_scale)
        else:
            frames = np.concatenate([x0.astype(np.float32), x1.astype(np.float32),
                                     xt.astype(np.float32), f0x, f1x], axis=2)
            frames = random_augment(self._rng, frames, self.crop_hw, with_flow=True)
            frames[:, :, :9] = frames[:, :, :9] / 255.0
            frames[:, :, 9:] = frames[:, :, 9:] * flow_scale
        return {"x0": frames[:, :, 0:3], "x1": frames[:, :, 3:6], "xt": frames[:, :, 6:9],
                "t": np.full((1, 1, 1), 0.5, np.float32),
                "f0x": frames[:, :, 9:11], "f1x": frames[:, :, 11:13]}
