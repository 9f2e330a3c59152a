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
    ``tri_testlist.txt``; a training tree also has ``tri_trainlist.txt``
    and, per training sequence, ``flow/<seq>/flow_t0.flo`` and
    ``flow_t1.flo``: the scene's true flows from t = 0.5 to frames 0 and 1,
    in pixels (training scenes of the generator's training split); with a
    ``flow_dir`` also ``<flow_dir>/<seq>/flow_01.npy`` and ``flow_10.npy``,
    the true flows from frame 0 to frame 1 and back, in pixels
    (``SyntheticMotion.frame_flows``: the same layers' displacements between
    times 0 and 1, weighted by their visibility in the start frame), which
    IFRNet's config reads (``distill_bwd: false``);
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
from ..data.readers import write_flo
from ..data.synthetic import SyntheticMotion
from ..eval.benchmarks import SNU_LEVELS


def triplet(hw: tuple[int, int], seed: int, index: int = 0):
    """``(frame 0, frame at t = 0.5, frame 1)`` of held-out scene ``index``
    of ``SyntheticMotion(seed=seed)`` at ``hw``, uint8 ``(H, W, 3)``."""
    item = SyntheticMotion(crop_hw=hw, is_train=False, seed=seed, num_items=index + 1,
                           fixed_t=0.5)[index]
    return tuple(_quantise(item[k]) for k in ("x0", "xt", "x1"))


def _quantise(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


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


VIMEO_TRAIN_NAME = "{:05d}/0002"   # training sequences; the test split's are .../0001


def write_vimeo90k_train_sequence(root: str | Path, index: int, hw: tuple[int, int],
                                  seed: int, flow_dir: str | None = None) -> None:
    """Training sequence ``index`` of a Vimeo90K tree under ``root``:
    scene ``index`` of the generator's training split at t = 0.5, its
    frames as PNG and its true flows t->0 and t->1 (pixels) as ``.flo``;
    with ``flow_dir``, also its true flows 0->1 and 1->0 (pixels) as
    ``<flow_dir>/<seq>/flow_01.npy`` and ``flow_10.npy``."""
    item = SyntheticMotion(crop_hw=hw, is_train=True, seed=seed, num_items=index + 1,
                           flow_in_pixels=True, fixed_t=0.5)[index]
    root = Path(root)
    name = VIMEO_TRAIN_NAME.format(index + 1)
    for k, f in (("x0", "im1.png"), ("xt", "im2.png"), ("x1", "im3.png")):
        _write(root / "sequences" / name / f, _quantise(item[k]))
    flow = root / "flow" / name
    flow.mkdir(parents=True, exist_ok=True)
    write_flo(str(flow / "flow_t0.flo"), item["f0x"])
    write_flo(str(flow / "flow_t1.flo"), item["f1x"])
    if flow_dir is not None:
        write_vimeo90k_forward_flows(root, index, hw, seed, flow_dir)


def write_vimeo90k_forward_flows(root: str | Path, index: int, hw: tuple[int, int], seed: int,
                                 flow_dir: str) -> None:
    """Training sequence ``index``'s true flows 0->1 and 1->0 (pixels), as
    ``<flow_dir>/<seq>/flow_01.npy`` and ``flow_10.npy`` under ``root``."""
    ds = SyntheticMotion(crop_hw=hw, is_train=True, seed=seed, num_items=index + 1,
                         flow_in_pixels=True)
    forward = Path(root) / flow_dir / VIMEO_TRAIN_NAME.format(index + 1)
    forward.mkdir(parents=True, exist_ok=True)
    f01, f10 = ds.frame_flows(index)
    np.save(forward / "flow_01.npy", f01)
    np.save(forward / "flow_10.npy", f10)


def write_vimeo90k_trainlist(root: str | Path, n_train: int) -> None:
    """``tri_trainlist.txt`` naming training sequences ``0 .. n_train - 1``."""
    names = [VIMEO_TRAIN_NAME.format(i + 1) for i in range(n_train)]
    (Path(root) / "tri_trainlist.txt").write_text("".join(f"{n}\n" for n in names))


def write_vimeo90k_train(base: str | Path, n_train: int, train_hw: tuple[int, int],
                         test_hws, seed: int, flow_dir: str | None = None) -> Path:
    """A Vimeo90K tree with a training split of ``n_train`` sequences at
    ``train_hw`` (:func:`write_vimeo90k_train_sequence`, with the forward
    flows under ``flow_dir`` where one is given) and the test split of
    :func:`write_vimeo90k`; returns the root."""
    root = write_vimeo90k(base, test_hws, seed)
    write_vimeo90k_trainlist(root, n_train)
    for i in range(n_train):
        write_vimeo90k_train_sequence(root, i, train_hw, seed, flow_dir)
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
