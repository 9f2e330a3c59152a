"""The port's augmentations and native binding against the JAX package's (CPU).

Every step and ``random_augment`` equal the JAX functions bit for bit,
except where the 2x upscale fires on non-integer values. ``resize2x``
replaces ``cv2.resize(..., fx=2, fy=2, INTER_LINEAR)`` with numpy: on
integer-valued inputs (images read as uint8) it equals cv2 bit for bit
(every product and sum is exact); on other float32 inputs (flows) OpenCV
rounds some of its multiply-adds otherwise, and the two differ by at most
``RESIZE_TOL`` of the input's max abs (4 float32 ulps there; measured 1.1
ulps). The native binding builds ``native/vfi_data.cc`` itself and equals
the JAX package's binding of the same file bit for bit.
"""

import numpy as np
import pytest

from videoframeinterpolation_tpu.data import augment as jax_aug
from videoframeinterpolation_tpu.data.native import augment_triplet_native as jax_native
from videoframeinterpolation_tpu_torch.data import augment
from videoframeinterpolation_tpu_torch.data.native import augment_triplet_native

RESIZE_TOL = 2.0 ** -21


def _stack(rng, h, w, with_flow):
    imgs = rng.integers(0, 256, (h, w, 9)).astype(np.float32)
    if not with_flow:
        return imgs
    flows = (rng.standard_normal((h, w, 4)) * 3).astype(np.float32)
    return np.concatenate([imgs, flows], axis=2)


@pytest.mark.parametrize("with_flow", [False, True])
def test_each_step_equals_jax(with_flow):
    rng = np.random.default_rng(0)
    x = _stack(rng, 12, 18, with_flow)
    pairs = [(augment.crop(x, 2, 3, 8, 10), jax_aug.crop(x, 2, 3, 8, 10)),
             (augment.reverse_channels(x), jax_aug.reverse_channels(x)),
             (augment.vflip(x, with_flow), jax_aug.vflip(x, with_flow)),
             (augment.hflip(x, with_flow), jax_aug.hflip(x, with_flow))]
    pairs += [(augment.rot90(x, k, with_flow), jax_aug.rot90(x, k, with_flow)) for k in range(4)]
    for got, want in pairs:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_resize2x_against_cv2():
    rng = np.random.default_rng(1)
    for h, w in ((7, 9), (16, 24), (33, 20)):
        imgs = rng.integers(0, 256, (h, w, 9)).astype(np.float32)
        assert np.array_equal(augment.resize2x(imgs, False), jax_aug.resize2x(imgs, False))
        x = _stack(rng, h, w, True)
        got, want = augment.resize2x(x, True), jax_aug.resize2x(x, True)
        assert got.shape == want.shape == (2 * h, 2 * w, 13) and got.dtype == want.dtype
        assert np.array_equal(got[..., :9], want[..., :9])
        assert np.abs(got[..., 9:] - want[..., 9:]).max() <= RESIZE_TOL * np.abs(x[..., 9:]).max()


@pytest.mark.parametrize("with_flow", [False, True])
def test_random_augment_equals_jax_over_seeds(with_flow):
    x = _stack(np.random.default_rng(2), 20, 24, with_flow)
    resizes = []
    for seed in range(40):
        resized = np.random.default_rng(seed).uniform() < 0.1   # the pipeline's first draw
        resizes.append(resized)
        got = augment.random_augment(np.random.default_rng(seed), x, (12, 16), with_flow)
        want = jax_aug.random_augment(np.random.default_rng(seed), x, (12, 16), with_flow)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        if resized and with_flow:
            assert np.array_equal(got[..., :9], want[..., :9])
            assert np.abs(got - want).max() <= RESIZE_TOL * np.abs(x[..., 9:]).max() * 2
        else:
            assert np.array_equal(got, want), seed
    assert any(resizes) and not all(resizes)


def test_native_binding_equals_jax_binding():
    rng = np.random.default_rng(3)
    h, w = 21, 30
    x0, x1, xt = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(3))
    f0, f1 = ((rng.standard_normal((h, w, 2)) * 4).astype(np.float32) for _ in range(2))
    for i, (rev, vf, hf, rot) in enumerate((a, b, c, r) for a in (0, 1) for b in (0, 1)
                                           for c in (0, 1) for r in range(4)):
        kw = dict(crop_hw=(16, 12), h_off=i % 5, w_off=(3 * i) % 18, chan_reverse=bool(rev),
                  vflip=bool(vf), hflip=bool(hf), rot=rot, img_scale=1 / 255,
                  flow_scale=1 / 255 if i % 2 else 1.0)
        flows = (f0, f1) if i % 3 else (None, None)
        got = augment_triplet_native(x0, x1, xt, *flows, **kw)
        want = jax_native(x0, x1, xt, *flows, **kw)
        assert want is not None and got.dtype == want.dtype and np.array_equal(got, want), kw
    with pytest.raises(ValueError):
        augment_triplet_native(x0, x1, xt, f0, None, **kw)
    with pytest.raises(ValueError):
        augment_triplet_native(x0.astype(np.float32), x1, xt, None, None, **kw)
