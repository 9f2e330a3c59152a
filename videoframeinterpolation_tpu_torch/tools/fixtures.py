"""Seeded benchmark trees in the layouts the evaluation loops read, written as PNG by the port's encoder.

No Vimeo90K, UCF101 or SNU-FILM copy ships with the repository. These
functions write small trees in each dataset's layout under ``base``, at
the paths the configs' default roots name (relative to a working directory
of ``base``), with frames rendered by the procedural generator
(:class:`..data.SyntheticMotion`, held-out split): frame 0, the true frame
at t = 0.5, and frame 1 of a moving scene, quantised to uint8. The same
seed gives the same bytes on every machine, so a loop's read of a tree on
one machine can be held against another's.

  * Vimeo90K: ``datasets/vimeo_triplet/sequences/<seq>/im{1,2,3}.png`` and
    ``tri_testlist.txt``;
  * UCF101: ``datasets/UCF-101/test/<n>/frame_{00,01_gt,02}.png``;
  * SNU-FILM: ``datasets/SNU-FILM/test/<seq>/{0,1,2}.png`` and
    ``test-{easy,medium,hard,extreme}.txt``, each line ``i0 gt i1`` with
    the ``data/SNU-FILM/...`` prefix of the real lists (the loop remaps it
    to ``datasets/``). Each of the first three levels lists one triplet
    (level ``i`` the ``i % n``-th of ``n``) and ``extreme`` lists them all,
    so that with three triplets or more each level reads its own frames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data.png import encode_png
from ..data.synthetic import SyntheticMotion
from ..eval.benchmarks import SNU_LEVELS


def triplet(hw: tuple[int, int], seed: int, index: int = 0):
    """``(frame 0, frame at t = 0.5, frame 1)`` of held-out scene ``index``
    of ``SyntheticMotion(seed=seed)`` at ``hw``, uint8 ``(H, W, 3)``."""
    item = SyntheticMotion(crop_hw=hw, is_train=False, seed=seed, num_items=index + 1,
                           fixed_t=0.5)[index]
    return tuple(np.clip(np.round(item[k] * 255.0), 0, 255).astype(np.uint8)
                 for k in ("x0", "xt", "x1"))


def _write(path: Path, img: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img))


def write_vimeo90k(base: str | Path, hws, seed: int) -> Path:
    """One triplet per ``(H, W)`` of ``hws``; returns the root."""
    root = Path(base) / "datasets" / "vimeo_triplet"
    names = []
    for i, hw in enumerate(hws):
        name = f"{i + 1:05d}/0001"
        for img, f in zip(triplet(hw, seed, i), ("im1.png", "im2.png", "im3.png")):
            _write(root / "sequences" / name / f, img)
        names.append(name)
    (root / "tri_testlist.txt").write_text("".join(f"{n}\n" for n in names))
    return root


def write_ucf101(base: str | Path, hws, seed: int) -> Path:
    """One triplet per ``(H, W)`` of ``hws``; returns the root."""
    root = Path(base) / "datasets" / "UCF-101" / "test"
    for i, hw in enumerate(hws):
        for img, f in zip(triplet(hw, seed, i),
                          ("frame_00.png", "frame_01_gt.png", "frame_02.png")):
            _write(root / str(i) / f, img)
    return root


def write_snu(base: str | Path, hws, seed: int) -> Path:
    """One triplet per ``(H, W)`` of ``hws``, listed as
    :func:`write_snu_triplets` lists them; returns the root."""
    return write_snu_triplets(base, [triplet(hw, seed, i) for i, hw in enumerate(hws)])


def write_snu_triplets(base: str | Path, triplets) -> Path:
    """The SNU-FILM layout of ``(frame 0, true middle, frame 1)`` uint8
    triplets: level ``i`` of the first three lists triplet ``i % n``, the
    last lists every triplet; returns the root."""
    root = Path(base) / "datasets" / "SNU-FILM"
    lines = []
    for i, frames in enumerate(triplets):
        paths = []
        for img, f in zip(frames, ("0.png", "1.png", "2.png")):
            _write(root / "test" / f"seq{i}" / f, img)
            paths.append(f"data/SNU-FILM/test/seq{i}/{f}")
        lines.append(" ".join(paths) + "\n")
    for i, level in enumerate(SNU_LEVELS):
        listed = lines if i == len(SNU_LEVELS) - 1 else [lines[i % len(lines)]]
        (root / level).write_text("".join(listed))
    return root
