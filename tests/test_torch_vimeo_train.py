"""The Vimeo90K training split and ``Vimeo90KwFlow`` against the JAX package (CPU).

A seeded tree in Vimeo90K's layout (PNG by the port's encoder, ``.flo``
by ``write_flo``, and seeded ``.npy`` flows for ``distill_bwd=False``)
is read by both frameworks' datasets with the same seeds. Each item equals
JAX's bit for bit, on the native and the numpy paths, for both flow
sources and both flow units; on the flow path, an item whose stack was
upscaled keeps its images bit-equal and its flows within the upscale's
stated tolerance (``tests/test_torch_augment.py``: OpenCV and the port's
numpy upscale round some flow values 1 ulp apart). The draws each item took
are recorded, and every branch is asserted as taken: the temporal swap
both ways, the upscale, the channel reverse, both flips and rotations 0-3.
The loaders' batches are equal at ``num_workers=1``.
"""

import copy

import numpy as np
import pytest

from videoframeinterpolation_tpu.data import DataLoader as JaxLoader
from videoframeinterpolation_tpu.data.vimeo90k import Vimeo90K as JaxVimeo90K
from videoframeinterpolation_tpu.data.vimeo90k import Vimeo90KwFlow as JaxVimeo90KwFlow
from videoframeinterpolation_tpu_torch.data import DataLoader, Vimeo90K, Vimeo90KwFlow
from videoframeinterpolation_tpu_torch.data import vimeo90k
from videoframeinterpolation_tpu_torch.tools import fixtures

N_SEQ, HW, CROP = 5, (24, 32), (16, 16)
RESIZE_TOL = 2.0 ** -21   # of the flows' max abs (tests/test_torch_augment.py)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("vimeo")
    root = fixtures.write_vimeo90k_train(base, N_SEQ, HW, [(16, 16)], seed=5)
    rng = np.random.default_rng(6)
    for i in range(N_SEQ):
        d = root / "flow" / fixtures.VIMEO_TRAIN_NAME.format(i + 1)
        for name in ("flow_01.npy", "flow_10.npy"):
            np.save(d / name, (rng.standard_normal(HW + (2,)) * 3).astype(np.float32))
    return str(root)


class Recorder:
    """Records, per item of the port's dataset, the branches its draws took."""

    def __init__(self, monkeypatch, ds):
        self.items, self.ds = [], ds
        read_image, native, augment = (vimeo90k.read_image, vimeo90k.augment_triplet_native,
                                       vimeo90k.random_augment)

        def reading(path):
            if path.endswith(("im1.png", "im3.png")) and self._first:
                self._first = False
                self.cur["swapped"] = path.endswith("im3.png")
            return read_image(path)

        def native_(*args, **kw):
            self.cur.update(resize=args[0].shape[:2] != tuple(HW), rev=kw["chan_reverse"],
                            vflip=kw["vflip"], hflip=kw["hflip"], rot=kw["rot"])
            return native(*args, **kw)

        def augment_(rng, frames, crop_hw, with_flow):
            replay = copy.deepcopy(rng)
            resize = replay.uniform() < 0.1
            h, w = (2 * s for s in frames.shape[:2]) if resize else frames.shape[:2]
            replay.integers(0, h - crop_hw[0] + 1)
            replay.integers(0, w - crop_hw[1] + 1)
            rev, vf, hf = (replay.uniform() < 0.5 for _ in range(3))
            self.cur.update(resize=resize, rev=rev, vflip=vf, hflip=hf,
                            rot=int(replay.integers(0, 4)))
            return augment(rng, frames, crop_hw, with_flow)

        monkeypatch.setattr(vimeo90k, "read_image", reading)
        monkeypatch.setattr(vimeo90k, "augment_triplet_native", native_)
        monkeypatch.setattr(vimeo90k, "random_augment", augment_)

    def __getitem__(self, idx):
        self.cur, self._first = {}, True
        item = self.ds[idx]
        self.items.append(self.cur)
        return item

    def assert_every_branch(self):
        seen = {(k, v) for it in self.items for k, v in it.items()}
        want = ({(k, b) for k in ("swapped", "resize", "rev", "vflip", "hflip")
                 for b in (False, True)} | {("rot", k) for k in range(4)})
        assert want <= seen, sorted(want - seen)


def _compare(ours: dict, ref: dict, resized: bool):
    assert list(ours) == list(ref)
    for k in ours:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        if resized and k in ("f0x", "f1x"):
            scale = np.abs(ref[k]).max()
            assert np.abs(ours[k] - ref[k]).max() <= RESIZE_TOL * scale, k
        else:
            assert np.array_equal(ours[k], ref[k]), k


def _run(monkeypatch, ours, ref, epochs: int) -> Recorder:
    rec = Recorder(monkeypatch, ours)
    for epoch in range(epochs):
        ours.seed(1000 + epoch)
        ref.seed(1000 + epoch)
        for i in range(len(ours)):
            item = rec[i]
            _compare(item, ref[i], rec.items[-1]["resize"])
    return rec


def test_vimeo90k_training_items_equal_jax(root, monkeypatch):
    rec = _run(monkeypatch, Vimeo90K(root, CROP, is_train=True, seed=3),
               JaxVimeo90K(root, CROP, is_train=True, seed=3), epochs=16)
    rec.assert_every_branch()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_vimeo90kwflow_items_equal_jax_with_every_branch(root, monkeypatch, native):
    ours = Vimeo90KwFlow(root, crop_hw=CROP, seed=3, use_native=native)
    ref = JaxVimeo90KwFlow(root, crop_hw=CROP, seed=3)
    ref.use_native = native
    rec = _run(monkeypatch, ours, ref, epochs=16)
    rec.assert_every_branch()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("distill_bwd, flow_in_pixels", [(False, False), (True, True),
                                                          (False, True)])
def test_vimeo90kwflow_flow_sources_and_units(root, monkeypatch, native, distill_bwd,
                                              flow_in_pixels):
    kw = dict(crop_hw=CROP, seed=4, distill_bwd=distill_bwd, flow_in_pixels=flow_in_pixels)
    ours = Vimeo90KwFlow(root, use_native=native, **kw)
    ref = JaxVimeo90KwFlow(root, **kw)
    ref.use_native = native
    _run(monkeypatch, ours, ref, epochs=3)


def test_loader_batches_equal_jax_at_one_worker(root):
    ours, ref = Vimeo90KwFlow(root, crop_hw=CROP, seed=7), JaxVimeo90KwFlow(root, crop_hw=CROP,
                                                                           seed=7)
    kw = dict(shuffle=True, drop_last=True, num_workers=1, seed=7)
    a, b = DataLoader(ours, 2, **kw), JaxLoader(ref, 2, **kw)
    for epoch in range(3):
        for loader, ds in ((a, ours), (b, ref)):
            loader.set_epoch(epoch)
            ds.seed(7 * 100003 + epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) == N_SEQ // 2
        for x, y in zip(got, want):
            assert list(x) == list(y)
            for k in x:
                if k in ("f0x", "f1x"):   # within the upscale's tolerance where it fired
                    assert np.abs(x[k] - y[k]).max() <= RESIZE_TOL * np.abs(y[k]).max(), k
                else:
                    assert np.array_equal(x[k], y[k]), k
