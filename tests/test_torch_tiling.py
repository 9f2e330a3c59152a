"""The port's spatial tiling, its flow probe and its serving CLI on PNG against the JAX package (CPU).

Tolerances:
  * the plan's arithmetic (``required_overlap``, ``_tile_starts``,
    ``_grid``, ``_feather_1d``, ``_blend_weights``): exactly equal;
  * ``resize_linear_antialias`` against ``jax.image.resize(..., "linear")``:
    1e-6 max abs (both build float32 weights; the contractions sum in
    different orders);
  * the flow probe of the small DAT (``tests/torch_tiny.py``, one encoder block) in fp32:
    magnitude within 1e-4 relative, and the plan it gives equal;
  * ``make_tiled_infer``, ``make_tiled_multi_t``, ``tiled_inference`` and
    the flow-aware routing (a frame no larger than the tile runs whole; an
    unsafe plan warns and runs whole, or raises): 1e-5 max abs against the
    JAX functions in fp32, on a small convolution model (any tile layout
    and padding) and on the small DAT;
  * the serving CLI on PNG frames with ``--tile``: its frames equal to the
    port's own functions (``tests/test_torch_benchmarks.py`` holds the
    pair-mode frame to the JAX CLI's).
"""

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_tiny import TINY_ENC1, jax_tiny, write_tiny_checkpoint
from videoframeinterpolation_tpu.parallel import spatial as jsp
from videoframeinterpolation_tpu_torch import interpolate
from videoframeinterpolation_tpu_torch.data import decode_png, encode_png
from videoframeinterpolation_tpu_torch.models import multi_t_apply
from videoframeinterpolation_tpu_torch.ops import resize_linear_antialias
from videoframeinterpolation_tpu_torch.parallel import spatial as sp

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
PROBE_REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``(port model, JAX model, JAX params, JAX jitted apply)`` of the small
    DAT, with one encoder block."""
    ckpt = write_tiny_checkpoint(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt", seed=1,
                                 cfg=TINY_ENC1)
    jmodel, params, apply = jax_tiny(ckpt, TINY_ENC1)
    return interpolate.load_model(TINY_ENC1, ckpt, device="cpu"), jmodel, params, apply


def _pair(h, w, seed, shift=(1, 2)):
    rng = np.random.default_rng(seed)
    x0 = rng.random((1, h, w, 3), dtype=np.float32)
    return x0, np.roll(x0, shift, axis=(1, 2)).copy()


def _smooth_pair(h, w, seed, shift=(1, 2)):
    """A smooth texture (coarse noise upsampled) and its shifted copy: the
    DAT's flows on white noise are chaotic, and its two fp32 forwards
    drift apart there by up to 1e-4 (``tests/test_torch_dat.py``)."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, h // 8 + 2, w // 8 + 2), dtype=np.float32))
    tex = F.interpolate(coarse, size=(h + 8, w + 8), mode="bilinear", align_corners=True)
    tex = tex[0].permute(1, 2, 0).numpy()
    dy, dx = shift
    return tex[None, 4:4 + h, 4:4 + w].copy(), tex[None, 4 + dy:4 + dy + h, 4 + dx:4 + dx + w].copy()


T5 = np.full((1, 1, 1, 1), 0.5, np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("mag", [0.0, 3.5, 15.9, 16.0, 28.1, 40.0, 47.9, 48.0, 200.0])
@pytest.mark.parametrize("kw", [{}, {"quantize": 1}, {"offset_reach_px": 0.0, "feather_px": 8}])
def test_required_overlap_equals_jax(mag, kw):
    assert sp.required_overlap(mag, **kw) == jsp.required_overlap(mag, **kw)


def test_tile_arithmetic_equals_jax():
    for size, tile, stride in [(96, 48, 32), (100, 48, 32), (48, 48, 16), (30, 48, 16),
                               (720, 512, 416), (1280, 512, 416), (97, 33, 17)]:
        assert sp._tile_starts(size, tile, stride) == jsp._tile_starts(size, tile, stride)
    for args in [(64, 32, 16, True, True), (64, 32, 8, False, True), (48, 16, 4, True, False),
                 (512, 96, 48, True, True), (33, 1, 0, True, True)]:
        ours, ref = sp._feather_1d(*args), jsp._feather_1d(*args)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    for H, W, tile, overlap, trim in [(96, 128, 48, 16, None), (61, 93, 32, 12, 5),
                                      (720, 1280, 512, 96, 48), (40, 40, 64, 16, 100)]:
        g = sp._grid(H, W, (tile, tile), overlap)
        assert g == jsp._grid(H, W, (tile, tile), overlap)
        th, tw, coords = g
        ours = sp._blend_weights(coords, th, tw, H, W, overlap, trim)
        ref = jsp._blend_weights(coords, th, tw, H, W, overlap, trim)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("src,dst", [((720, 1280), (176, 320)), ((64, 96), (32, 32)),
                                     ((37, 53), (32, 40)), ((32, 32), (64, 48)),
                                     ((48, 80), (48, 32))])
def test_antialiased_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(sum(src)).random((2, *src, 3), dtype=np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "linear"))
    out = resize_linear_antialias(torch.from_numpy(x), dst).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-6


def test_flow_probe_and_plan_match_jax(tiny):
    model, jmodel, params, _ = tiny
    x0, x1 = _pair(64, 96, seed=3, shift=(2, 3))
    jprobe = jsp.make_flow_probe(lambda p, a, b, t, train: jmodel.apply(p, a, b, t, train=train))
    ref = jprobe(params, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(T5))
    train_apply = interpolate._train_apply
    ours = sp.make_flow_probe(train_apply)(model, *_t(x0, x1, T5))
    eager = sp.estimate_flow_magnitude(train_apply, model, *_t(x0, x1, T5))
    print(f"probe magnitude: port {ours}, JAX {ref}")
    assert abs(ours - ref) <= PROBE_REL_TOL * abs(ref) and ours > 0
    assert abs(eager - ours) <= 1e-6 * ours
    for tile in (64, 128, 256, 512):
        for scale in (1.0, 1.5):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = sp._plan_tiles(lambda *a: ours, None, None, None, None, tile,
                                     default_flow_px=32.0, unsafe_plan="full", mag_scale=scale)
                want = jsp._plan_tiles(lambda *a: ref, None, None, None, None, tile,
                                       default_flow_px=32.0, unsafe_plan="full",
                                       mag_scale=scale)
            assert got == want, (tile, scale)


def _conv_model(seed):
    """A two-convolution model on both sides: ``(port apply, JAX apply)``."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, 0.3, (3, 3, 6, 8)).astype(np.float32)    # HWIO
    w2 = rng.normal(0, 0.3, (3, 3, 8, 3)).astype(np.float32)

    def jax_apply(p, a, b, t):
        dn = ("NHWC", "HWIO", "NHWC")
        h = jax.lax.conv_general_dilated(jnp.concatenate([a, b], -1), w1, (1, 1), "SAME",
                                         dimension_numbers=dn)
        h = jax.lax.conv_general_dilated(jax.nn.relu(h), w2, (1, 1), "SAME",
                                         dimension_numbers=dn)
        return h + 0.1 * t

    k1, k2 = (torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in (w1, w2))

    def port_apply(p, a, b, t):
        h = F.conv2d(torch.cat([a, b], -1).permute(0, 3, 1, 2), k1, padding=1)
        h = F.conv2d(F.relu(h), k2, padding=1).permute(0, 2, 3, 1)
        return h + 0.1 * t

    return port_apply, jax_apply


@pytest.mark.parametrize("hw,tile,overlap,trim,tile_batch", [
    ((61, 93), 32, 12, 5, 3),      # odd sizes, a trim, the last chunk padded
    ((30, 72), 48, 16, None, 8)])  # a frame lower than the tile; 2 tiles padded to 8
def test_tile_sweeps_match_jax(hw, tile, overlap, trim, tile_batch):
    port_apply, jax_apply = _conv_model(seed=tile + overlap)
    x0, x1 = _pair(*hw, seed=4)
    kw = dict(tile_hw=(tile, tile), overlap=overlap, trim=trim, tile_batch=tile_batch)
    ref = np.asarray(jsp.make_tiled_infer(jax_apply, **kw)(None, x0, x1, T5))
    ours = sp.make_tiled_infer(port_apply, **kw)(None, *_t(x0, x1, T5)).numpy()
    assert ours.shape == ref.shape == (1, *hw, 3)
    assert np.abs(ours - ref).max() <= TOL
    hosted = sp.tiled_inference(lambda a, b, t: port_apply(None, a, b, t), *_t(x0, x1, T5), **kw)
    ref_hosted = np.asarray(jsp.tiled_inference(lambda a, b, t: jax_apply(None, a, b, t),
                                                jnp.asarray(x0), jnp.asarray(x1),
                                                jnp.asarray(T5), **kw))
    assert np.abs(hosted.numpy() - ref_hosted).max() <= TOL
    ts = (0.25, 0.5, 0.75)

    def port_multi(p, a, b):
        return torch.stack([port_apply(p, a, b, torch.full((a.shape[0], 1, 1, 1), t))
                            for t in ts])

    def jax_multi(p, a, b):
        return jnp.stack([jax_apply(p, a, b, jnp.full((a.shape[0], 1, 1, 1), t)) for t in ts])

    ref_multi = np.asarray(jsp.make_tiled_multi_t(jax_multi, **kw)(None, x0, x1))
    ours_multi = sp.make_tiled_multi_t(port_multi, **kw)(None, *_t(x0, x1)).numpy()
    assert ours_multi.shape == ref_multi.shape == (3, 1, *hw, 3)
    assert np.abs(ours_multi - ref_multi).max() <= TOL


def test_flow_aware_routing_matches_jax():
    port_apply, jax_apply = _conv_model(seed=9)
    small = _pair(48, 48, seed=5)
    big = _pair(64, 160, seed=6)
    for x0, x1 in (small, big):
        for flow, tile in ((0.0, 64), (200.0, 64)):
            kw = dict(default_flow_px=flow, verbose=False)
            with warnings.catch_warnings(record=True) as ours_w:
                warnings.simplefilter("always")
                ours = sp.make_flow_aware_tiled(port_apply, None, tile, **kw)(
                    *_t(x0, x1, T5)).numpy()
            with warnings.catch_warnings(record=True) as ref_w:
                warnings.simplefilter("always")
                ref = np.asarray(jsp.make_flow_aware_tiled(jax_apply, None, tile, **kw)(
                    jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(T5)))
            assert np.abs(ours - ref).max() <= TOL
            assert [str(w.message) for w in ours_w] == [str(w.message) for w in ref_w]
            if x0.shape[2] > tile and flow:
                assert any("FULL-FRAME" in str(w.message) for w in ours_w)
                full = port_apply(None, *_t(x0, x1, T5)).numpy()
                assert np.array_equal(ours, full)
    x0, x1 = big
    with pytest.raises(ValueError, match="make_sharded_infer"):
        sp.make_flow_aware_tiled(port_apply, None, 64, default_flow_px=200.0, verbose=False,
                                 unsafe_plan="raise")(*_t(x0, x1, T5))
    with pytest.raises(ValueError, match="unsafe_plan"):
        sp.make_flow_aware_tiled(port_apply, None, 64, unsafe_plan="never")

    def no_pyramids(p, a, b, t, train=True):
        return a, {}

    infer = sp.make_flow_aware_tiled(port_apply, None, 64, train_apply_fn=no_pyramids,
                                     default_flow_px=0.0, verbose=False)
    with pytest.warns(UserWarning, match="falling back to default_flow_px"):
        infer(*_t(x0, x1, T5))
    assert list(infer.plans) == [(32, 16)]
    for fn in (sp.make_tiled_infer, sp.make_tiled_multi_t):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            fn(port_apply, mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        sp.make_sharded_infer(port_apply, object())


def test_flow_aware_tiling_of_the_dat_matches_jax(tiny):
    """The small DAT through the flow-aware paths at a plan they both tile
    with (no probe, no motion): single-instant against JAX's at each
    instant, and multi-instant against those (JAX's multi-instant sweep
    computes the same frames and takes twice as long to compile)."""
    model, jmodel, params, _ = tiny
    x0, x1 = _smooth_pair(64, 96, seed=7)
    kw = dict(default_flow_px=0.0, tile_batch=4, verbose=False)
    ts = (0.25, 0.5, 0.75)
    infer = sp.make_flow_aware_tiled(lambda m, a, b, t: m(a, b, t), model, 64, **kw)
    jinfer = jsp.make_flow_aware_tiled(jmodel.apply, params, 64, **kw)
    multi = sp.make_flow_aware_multi_t(lambda m, a, b: multi_t_apply(m, a, b, ts), model, 64,
                                       ts, **kw)
    with torch.no_grad():
        ours = [infer(*_t(x0, x1, np.full((1, 1, 1, 1), t, np.float32))).numpy() for t in ts]
        ours_multi = multi(*_t(x0, x1)).numpy()
    ref = [np.asarray(jinfer(x0, x1, np.full((1, 1, 1, 1), t, np.float32))) for t in ts]
    assert list(infer.plans) == list(multi.plans) == [(32, 16)]
    assert ours_multi.shape == (3, 1, 64, 96, 3)
    for k in range(len(ts)):
        assert ours[k].shape == ref[k].shape == (1, 64, 96, 3)
        assert np.abs(ours[k] - ref[k]).max() <= TOL
        assert np.abs(ours_multi[k] - ref[k]).max() <= TOL
        assert np.array_equal(ours_multi[k], ours[k])


def _png_frames(tmp_path, n, h, w):
    rng = np.random.default_rng(11)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    frames = [np.roll(base, 2 * i, axis=1) for i in range(n)]
    paths = []
    for i, img in enumerate(frames):
        paths.append(tmp_path / f"f{i:02d}.png")
        paths[-1].write_bytes(encode_png(img))
    return frames, paths


def test_cli_pair_mode_tiles_png_frames_as_the_functions_do(tiny, tmp_path, monkeypatch):
    """``--tile`` no smaller than the frame runs it whole; a smaller tile
    probes the pair, and the small DAT's motion needs more overlap than a
    32-pixel tile holds, so the pair runs whole with a warning."""
    model = tiny[0]
    monkeypatch.setattr(interpolate, "load_model", lambda cfg, ckpt, device: model)
    (img0, img1), (p0, p1) = _png_frames(tmp_path, 2, 30, 44)
    out = tmp_path / "mid.png"
    want = interpolate.interp_pair(model, img0, img1, 0.25)
    args = ["--frame0", str(p0), "--frame1", str(p1), "--out", str(out), "--t", "0.25",
            "--device", "cpu"]
    for tile in ("0", "64"):
        interpolate.main(args + ["--tile", tile])
        assert np.array_equal(decode_png(out.read_bytes()), want)
    with pytest.warns(UserWarning, match="FULL-FRAME"):
        interpolate.main(args + ["--tile", "32"])
    assert np.array_equal(decode_png(out.read_bytes()), want)


@pytest.mark.parametrize("mode", ["recursive", "direct"])
def test_cli_sequence_modes_on_png_with_tiles(tiny, tmp_path, monkeypatch, mode):
    """PNG frames in, ``%06d.png`` out, tiled with a tile smaller than the
    frame: the small DAT's flows need more overlap than a 32-pixel tile
    holds, so each pair runs whole, with a warning, as the JAX CLI runs it."""
    model = tiny[0]
    monkeypatch.setattr(interpolate, "load_model", lambda cfg, ckpt, device: model)
    (tmp_path / "in").mkdir()
    seq, _ = _png_frames(tmp_path / "in", 3, 32, 48)
    out_dir = tmp_path / "out"
    with pytest.warns(UserWarning, match="FULL-FRAME"):
        interpolate.main(["--in_dir", str(tmp_path / "in"), "--out_dir", str(out_dir),
                          "--factor", "2", "--mode", mode, "--tile", "32", "--device", "cpu"])
    names = sorted(p.name for p in out_dir.iterdir())
    assert names == [f"{i:06d}.png" for i in range(5)]
    frames = [decode_png((out_dir / n).read_bytes()) for n in names]
    want = interpolate.upsample_sequence(model, seq, 2, mode)
    for got, ref in zip(frames, want):
        assert np.array_equal(got, ref)
