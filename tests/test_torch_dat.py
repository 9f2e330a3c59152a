"""The port's flagship model and serving path against the JAX package (CPU).

Tolerances:
  * the small DATwConstantnC (nf 16, one encoder and one decoder block,
    64x64, perturbed parameters, fp32): 1e-4 max abs on the [0, 1] frame;
  * the shipped DAT_fast student at full width (nf 72), 64x64, in fp32 (a
    float32 copy of the config on both sides): 1e-3 max abs and 1e-5 mean
    abs. The two frameworks sum convolutions in different orders, and the
    differences pass through 40-odd layers.
  * the shipped student in bf16, as ``configs/DAT_fast.yaml`` has it, on
    both sides: mean abs error at most half of JAX's own gap between its
    bf16 and its fp32 frame on the same input, on a smooth frame pair (a
    smooth texture and its copy shifted by (2, 3) pixels). The port rounds
    to bf16 where JAX does; what remains are rounding flips where the two
    frameworks' fp32 sums straddle a bf16 boundary, which spread through
    the layers. Serving the model in fp32 sits at the whole gap. On the
    white-noise pair of the fp32 test the flows are chaotic and the flips
    grow further: there the port's bf16 frame is held to the whole gap.
  * ``interp_pair`` against the JAX CLI, uint8 frames: in fp32 within 1
    level, fewer than 0.1% of the values apart; in bf16, on a smooth pair
    within 1 level, and on average at most half as far apart as the JAX
    CLI's own bf16 and fp32 frames, and on the white-noise pair within 4
    levels, and on average no further apart than those.
  * ``read_flax_msgpack``: bit-exact against flax's own reader.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
import torch.nn.functional as F
from flax import serialization as fser

from torch_tiny import jax_init
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models.dat import DATwConstantnC as JaxDAT
from videoframeinterpolation_tpu_torch import interpolate
from videoframeinterpolation_tpu_torch.config import DAT_fast
from videoframeinterpolation_tpu_torch.interop import params_from_flax
from videoframeinterpolation_tpu_torch.models import DATwConstantnC, create_model
from videoframeinterpolation_tpu_torch.train import read_flax_msgpack

ROOT = Path(__file__).resolve().parent.parent
STUDENT = interpolate.SHIPPED_STUDENT
SMALL_TOL = 1e-4
STUDENT_MAX_TOL = 1e-3
STUDENT_MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
CLI_NOISE_MAX_LEVELS = 4
FP32 = dataclasses.replace(DAT_fast, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.random((1, h, w, 3), dtype=np.float32)
    x1 = np.roll(x0, (2, 3), axis=(1, 2))
    return x0, x1


def _video_pair(h, w, seed):
    """A smooth random texture (bilinear upsampling of coarse noise, one
    value per 16 pixels) and its copy shifted by (2, 3) pixels."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, h // 16 + 2, w // 16 + 2), dtype=np.float32))
    tex = F.interpolate(coarse, size=(h + 16, w + 16), mode="bilinear", align_corners=True)
    tex = tex[0].permute(1, 2, 0).numpy()
    return tex[None, 8:8 + h, 8:8 + w].copy(), tex[None, 10:10 + h, 11:11 + w].copy()


@pytest.fixture(scope="module")
def student():
    """The shipped student in fp32 as both frameworks load it: flax's reader
    for JAX, the port's reader for the port."""
    jcfg = JaxConfig.from_yaml(ROOT / "configs" / "DAT_fast.yaml", compute_dtype="float32")
    jmodel = jax_create_model(jcfg)
    jparams = fser.msgpack_restore(STUDENT.read_bytes())["params"]
    pmodel = interpolate.load_model(FP32, STUDENT, device="cpu")
    return jmodel, jparams, pmodel


@pytest.fixture(scope="module")
def student_bf16(student):
    """The shipped student as both packages serve it: ``configs/DAT_fast.yaml``
    as it stands (bf16) for JAX, ``DAT_fast`` through ``load_model`` for the port."""
    _, jparams, _ = student
    jmodel = jax_create_model(JaxConfig.from_yaml(ROOT / "configs" / "DAT_fast.yaml"))
    pmodel = interpolate.load_model(DAT_fast, STUDENT, device="cpu")
    return jmodel, jparams, pmodel


@pytest.fixture(scope="module")
def jax_apply(student, student_bf16):
    """The shipped student's jitted JAX forward in fp32 and in bf16, shared
    by the tests of this file (each compiles once per shape)."""
    return {"float32": jax.jit(student[0].apply), "bfloat16": jax.jit(student_bf16[0].apply)}


@pytest.mark.parametrize("shared_offsets,n_samples", [(True, (8, 8, 2)),
                                                      (False, (8, 16, 32))])
def test_small_dat_matches_jax(shared_offsets, n_samples):
    kw = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1, shared_offsets=shared_offsets,
              n_samples=n_samples)
    x0, x1 = _pair(64, 64, seed=1)
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    jmodel = JaxDAT(**kw)
    params = jax_init(jmodel, x0, x1, t)["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), params)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, x0, x1, t))

    pmodel = DATwConstantnC(**kw).eval()
    pmodel.load_state_dict(params_from_flax({"params": params}, pmodel))
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t)).numpy()
    assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= SMALL_TOL


def test_shipped_student_matches_jax(student, jax_apply):
    _, jparams, pmodel = student
    x0, x1 = _pair(64, 64, seed=3)
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    ref = np.asarray(jax_apply["float32"](jparams, x0, x1, t))
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t)).numpy()
    err = np.abs(out - ref)
    print(f"shipped student 64x64 fp32: max abs {err.max():.3e}, mean abs {err.mean():.3e}")
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert err.max() <= STUDENT_MAX_TOL and err.mean() <= STUDENT_MEAN_TOL


@pytest.mark.parametrize("pair", ["video", "white_noise"])
def test_shipped_student_bf16_matches_jax(student, student_bf16, jax_apply, pair):
    _, jparams, _ = student
    _, _, pmodel = student_bf16
    x0, x1 = _video_pair(64, 64, seed=3) if pair == "video" else _pair(64, 64, seed=3)
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    ref = np.asarray(jax_apply["bfloat16"](jparams, x0, x1, t))
    ref32 = np.asarray(jax_apply["float32"](jparams, x0, x1, t))
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t)).numpy()
    gap = np.abs(ref - ref32).mean()
    err = np.abs(out - ref)
    share = BF16_GAP_SHARE if pair == "video" else 1.0
    print(f"shipped student 64x64 bf16, {pair} pair: mean abs {err.mean():.3e} "
          f"(max {err.max():.3e}) against JAX's bf16-vs-fp32 gap {gap:.3e}: "
          f"{err.mean() / gap:.3f} of it, limit {share}")
    assert out.dtype == np.float32 and out.shape == ref.shape == (1, 64, 64, 3)
    assert err.mean() <= share * gap
    assert pmodel.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,pair", [("float32", "white_noise"), ("bfloat16", "video"),
                                        ("bfloat16", "white_noise")])
def test_interp_pair_matches_jax_cli(student, student_bf16, jax_apply, dtype, pair):
    """Padding (40x56 -> 48x64), inference, unpadding and uint8 quantisation
    against the JAX CLI's ``_interp_pair``, both serving the same config.

    fp32: quantisation may move a value that sits on a level boundary by
    one. bf16 (``configs/DAT_fast.yaml`` as it stands): the frames differ by
    rounding flips (see the module docstring); on the smooth pair at most 1
    level apart, and on average at most half as far apart as the JAX CLI's
    own bf16 and fp32 frames; on the white-noise pair, where the flips grow
    to about 1e-2, at most 4 levels apart, and on average no further apart
    than those."""
    _, jparams, pmodel32 = student
    _, _, pmodel16 = student_bf16
    spec = importlib.util.spec_from_file_location("jax_interpolate_cli", ROOT / "interpolate.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    if pair == "video":
        img0, img1 = ((f[0] * 255).astype(np.uint8) for f in _video_pair(40, 56, seed=4))
    else:
        rng = np.random.default_rng(4)
        img0 = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
        img1 = np.roll(img0, 2, axis=1)

    def jax_cli(dtype):
        apply = jax_apply[dtype]
        return cli._interp_pair(lambda a, b, t: apply(jparams, a, b, t), img0, img1,
                                0.25).astype(np.int16)

    ref32 = jax_cli("float32")
    if dtype == "float32":
        out = interpolate.interp_pair(pmodel32, img0, img1, 0.25)
        assert out.dtype == np.uint8 and out.shape == ref32.shape == (40, 56, 3)
        diff = np.abs(out.astype(np.int16) - ref32)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        return
    ref = jax_cli("bfloat16")
    out = interpolate.interp_pair(pmodel16, img0, img1, 0.25)
    assert out.dtype == np.uint8 and out.shape == ref.shape == (40, 56, 3)
    diff = np.abs(out.astype(np.int16) - ref)
    gap = np.abs(ref - ref32)
    print(f"interp_pair bf16 vs JAX CLI, {pair} pair: max {diff.max()} levels, mean "
          f"{diff.mean():.4f}; JAX CLI bf16 vs fp32: max {gap.max()}, mean {gap.mean():.4f}")
    if pair == "video":
        assert diff.max() <= 1 and diff.mean() <= BF16_GAP_SHARE * gap.mean()
    else:
        assert diff.max() <= CLI_NOISE_MAX_LEVELS and diff.mean() <= gap.mean()


def test_cli_main_writes_the_interpolated_frame(student_bf16, tmp_path):
    _, _, pmodel = student_bf16
    rng = np.random.default_rng(5)
    img0 = (rng.random((30, 50, 3)) * 255).astype(np.uint8)
    img1 = np.roll(img0, 3, axis=0)
    np.save(tmp_path / "a.npy", img0)
    np.save(tmp_path / "b.npy", img1)
    interpolate.main(["--frame0", str(tmp_path / "a.npy"), "--frame1", str(tmp_path / "b.npy"),
                      "--out", str(tmp_path / "mid.npy"), "--t", "0.5", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "mid.npy"),
                                  interpolate.interp_pair(pmodel, img0, img1, 0.5))


def test_read_flax_msgpack_matches_flax_bit_exact():
    ours = read_flax_msgpack(STUDENT)
    ref = fser.msgpack_restore(STUDENT.read_bytes())["params"]
    ours_leaves = jax.tree_util.tree_leaves_with_path(ours)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in ours_leaves] == [p for p, _ in ref_leaves]
    assert len(ours_leaves) > 200
    for (path, a), (_, b) in zip(ours_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == np.asarray(b).tobytes(), path


def test_dat_fast_preset_matches_the_yaml():
    ref = JaxConfig.from_yaml(ROOT / "configs" / "DAT_fast.yaml")

    def norm(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    for field in dataclasses.fields(DAT_fast):
        assert norm(getattr(DAT_fast, field.name)) == norm(getattr(ref, field.name)), field.name


def test_create_model_computes_in_the_configs_dtype():
    model = create_model(DAT_fast)
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert create_model(FP32).dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        create_model(dataclasses.replace(DAT_fast, compute_dtype="float16"))


def test_load_model_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interpolate.load_model(DAT_fast, STUDENT, device="cuda")


def test_params_from_flax_fills_the_whole_student(student):
    _, jparams, pmodel = student
    state = params_from_flax(jparams, pmodel)
    assert set(state) == set(pmodel.state_dict())
    n_flax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(jparams))
    assert sum(v.numel() for v in state.values()) == n_flax == 4564459
