"""The port's flagship model and serving path against the JAX package (CPU, fp32).

Tolerances:
  * the small DATwConstantnC (nf 16, one encoder and one decoder block,
    64x64, perturbed parameters): 1e-4 max abs on the [0, 1] frame;
  * the shipped DAT_fast student at full width (nf 72), 64x64: 1e-3 max abs
    and 1e-5 mean abs. The two frameworks sum convolutions in different
    orders, and the differences pass through 40-odd layers.
  * ``read_flax_msgpack``: bit-exact against flax's own reader.
The JAX model is built with ``compute_dtype`` float32 throughout.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
from flax import serialization as fser

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


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.random((1, h, w, 3), dtype=np.float32)
    x1 = np.roll(x0, (2, 3), axis=(1, 2))
    return x0, x1


@pytest.fixture(scope="module")
def student():
    """The shipped student as both frameworks load it: flax's reader for
    JAX, the port's reader for the port."""
    jcfg = JaxConfig.from_yaml(ROOT / "configs" / "DAT_fast.yaml", compute_dtype="float32")
    jmodel = jax_create_model(jcfg)
    jparams = fser.msgpack_restore(STUDENT.read_bytes())["params"]
    pmodel = interpolate.load_model(DAT_fast, STUDENT, device="cpu")
    return jmodel, jparams, pmodel


@pytest.mark.parametrize("shared_offsets,n_samples", [(True, (8, 8, 2)),
                                                      (False, (8, 16, 32))])
def test_small_dat_matches_jax(shared_offsets, n_samples):
    kw = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1, shared_offsets=shared_offsets,
              n_samples=n_samples)
    x0, x1 = _pair(64, 64, seed=1)
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    jmodel = JaxDAT(**kw)
    params = jax.jit(jmodel.init)(jax.random.key(0), x0, x1, t)["params"]
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


def test_shipped_student_matches_jax(student):
    jmodel, jparams, pmodel = student
    x0, x1 = _pair(64, 64, seed=3)
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(jparams, x0, x1, t))
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t)).numpy()
    err = np.abs(out - ref)
    print(f"shipped student 64x64 fp32: max abs {err.max():.3e}, mean abs {err.mean():.3e}")
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert err.max() <= STUDENT_MAX_TOL and err.mean() <= STUDENT_MEAN_TOL


def test_interp_pair_matches_jax_cli(student):
    """Padding (40x56 -> 48x64), inference, unpadding and uint8 quantisation
    against the JAX CLI's ``_interp_pair``; quantisation may move a value
    that sits on a level boundary by one."""
    jmodel, jparams, pmodel = student
    spec = importlib.util.spec_from_file_location("jax_interpolate_cli", ROOT / "interpolate.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    rng = np.random.default_rng(4)
    img0 = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    img1 = np.roll(img0, 2, axis=1)
    infer = jax.jit(lambda a, b, t: jmodel.apply(jparams, a, b, t))
    ref = cli._interp_pair(infer, img0, img1, 0.25)
    out = interpolate.interp_pair(pmodel, img0, img1, 0.25)
    assert out.dtype == np.uint8 and out.shape == ref.shape == (40, 56, 3)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_cli_main_writes_the_interpolated_frame(student, tmp_path):
    _, _, pmodel = student
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


def test_create_model_refuses_bf16():
    with pytest.raises(NotImplementedError, match="float32"):
        create_model(DAT_fast)


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
