"""The port's multi-instant serving and sequence modes (CPU).

Tolerances:
  * ``multi_t_apply`` against the JAX package's on the shipped student in
    fp32 (a float32 copy of ``DAT_fast`` on both sides), 64x64: 1e-3 max
    abs and 1e-5 mean abs, as for the single-instant forward
    (``tests/test_torch_dat.py``).
  * ``multi_t_apply`` against the port's own per-instant forward: equal
    (``torch.equal``), in fp32 and bf16. It runs the same operations on
    the same inputs.
  * The CLI's sequence modes: frame counts, order and names, and equality
    with the pair-mode frames they are made of.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization as fser

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models import multi_t_apply as jax_multi_t_apply
from videoframeinterpolation_tpu_torch import interpolate
from videoframeinterpolation_tpu_torch.config import DAT_fast, PRESETS
from videoframeinterpolation_tpu_torch.models import multi_t_apply

ROOT = Path(__file__).resolve().parent.parent
STUDENT = interpolate.SHIPPED_STUDENT
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
TS = (0.25, 0.5, 0.75)
FP32 = dataclasses.replace(DAT_fast, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return {"float32": interpolate.load_model(FP32, STUDENT, device="cpu"),
            "bfloat16": interpolate.load_model(DAT_fast, STUDENT, device="cpu")}


def _pair(b, h, w, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.random((b, h, w, 3), dtype=np.float32)
    return x0, np.roll(x0, (2, 3), axis=(1, 2))


def test_multi_t_apply_matches_jax(models):
    x0, x1 = _pair(2, 64, 64, seed=6)
    jcfg = JaxConfig.from_yaml(ROOT / "configs" / "DAT_fast.yaml", compute_dtype="float32")
    jmodel = jax_create_model(jcfg)
    params = fser.msgpack_restore(STUDENT.read_bytes())["params"]
    ref = np.asarray(jax.jit(lambda p, a, b: jax_multi_t_apply(jmodel, p, a, b, TS))(
        params, x0, x1))
    with torch.no_grad():
        out = multi_t_apply(models["float32"], torch.from_numpy(x0), torch.from_numpy(x1),
                            TS).numpy()
    err = np.abs(out - ref)
    print(f"multi_t_apply, shipped student fp32, B=2 64x64, t={TS}: max abs {err.max():.3e}, "
          f"mean abs {err.mean():.3e}")
    assert out.shape == ref.shape == (3, 2, 64, 64, 3)
    assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_t_apply_equals_the_per_instant_forward(models, dtype):
    model = models[dtype]
    x0, x1 = (torch.from_numpy(x) for x in _pair(1, 48, 64, seed=7))
    with torch.no_grad():
        frames = multi_t_apply(model, x0, x1, TS)
        for k, t in enumerate(TS):
            single = model(x0, x1, torch.full((1, 1, 1, 1), t))
            assert torch.equal(frames[k], single), (dtype, t)
    assert frames.dtype == torch.float32 and frames.shape == (3, 1, 48, 64, 3)


def test_multi_t_apply_refuses_no_instants(models):
    x0, x1 = (torch.from_numpy(x) for x in _pair(1, 32, 32, seed=8))
    with pytest.raises(ValueError, match="at least one instant"):
        multi_t_apply(models["float32"], x0, x1, ())


@pytest.mark.parametrize("mode,factor,message", [
    ("recursive", 3, "--mode recursive needs a power-of-2 --factor; use --mode direct for factor 3"),
    ("recursive", 6, "--mode recursive needs a power-of-2 --factor; use --mode direct for factor 6"),
    ("direct", 1, "--mode direct needs --factor >= 2 (factor 1 inserts no frames)"),
])
def test_cli_validates_the_factor_before_loading_the_model(tmp_path, monkeypatch, mode, factor,
                                                          message):
    def no_load(*args, **kwargs):
        raise AssertionError("the model was loaded before the arguments were checked")

    monkeypatch.setattr(interpolate, "load_model", no_load)
    with pytest.raises(SystemExit) as exc:
        interpolate.main(["--in_dir", str(tmp_path), "--factor", str(factor), "--mode", mode,
                          "--device", "cpu"])
    assert str(exc.value) == message


def test_cli_refuses_a_pair_mode_call_without_its_frames():
    with pytest.raises(SystemExit, match="--frame0, --frame1 and --out"):
        interpolate.main(["--frame0", "a.npy", "--device", "cpu"])


def _write_sequence(in_dir: Path, n: int, h: int = 24, w: int = 40) -> list[np.ndarray]:
    rng = np.random.default_rng(9)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    seq = [np.roll(base, 2 * i, axis=1) for i in range(n)]
    in_dir.mkdir()
    for i, img in enumerate(seq):
        np.save(in_dir / f"f{i:02d}.npy", img)
    (in_dir / "notes.txt").write_text("not a frame")
    return seq


@pytest.mark.parametrize("mode", ["recursive", "direct"])
@pytest.mark.parametrize("factor", [2, 4])
def test_cli_sequence_modes_write_every_frame(models, tmp_path, monkeypatch, mode, factor):
    model = models["bfloat16"]
    monkeypatch.setattr(interpolate, "load_model", lambda cfg, ckpt, device: model)
    seq = _write_sequence(tmp_path / "in", 3)
    out_dir = tmp_path / "out"
    interpolate.main(["--in_dir", str(tmp_path / "in"), "--out_dir", str(out_dir),
                      "--factor", str(factor), "--mode", mode, "--device", "cpu"])
    names = sorted(p.name for p in out_dir.iterdir())
    assert names == [f"{i:06d}.npy" for i in range(2 * factor + 1)]
    frames = [np.load(out_dir / n) for n in names]
    assert all(f.dtype == np.uint8 and f.shape == (24, 40, 3) for f in frames)
    # The input frames keep their places.
    for i, img in enumerate(seq):
        np.testing.assert_array_equal(frames[i * factor], img)
    if mode == "direct":
        # Each inserted frame is the pair-mode frame at its instant.
        for i in range(factor - 1):
            t = (i + 1) / factor
            np.testing.assert_array_equal(
                frames[1 + i], interpolate.interp_pair(model, seq[0], seq[1], t))
    else:
        np.testing.assert_array_equal(
            frames[factor // 2], interpolate.interp_pair(model, seq[0], frames[factor], 0.5))


def test_direct_factor_2_equals_recursive_factor_2(models):
    model = models["bfloat16"]
    rng = np.random.default_rng(10)
    seq = [(rng.random((20, 36, 3)) * 255).astype(np.uint8) for _ in range(3)]
    recursive = interpolate.upsample_sequence(model, seq, 2, "recursive")
    direct = interpolate.upsample_sequence(model, seq, 2, "direct")
    assert len(recursive) == len(direct) == 5
    for a, b in zip(recursive, direct):
        np.testing.assert_array_equal(a, b)


def test_cli_config_picks_the_preset_and_its_checkpoint(tmp_path, monkeypatch):
    seen = []

    def fake_load(cfg, ckpt, device):
        seen.append((cfg, ckpt, device))
        raise SystemExit("stop after the load")

    monkeypatch.setattr(interpolate, "load_model", fake_load)
    img = np.zeros((16, 16, 3), np.uint8)
    np.save(tmp_path / "a.npy", img)
    args = ["--frame0", str(tmp_path / "a.npy"), "--frame1", str(tmp_path / "a.npy"),
            "--out", str(tmp_path / "m.npy"), "--device", "cpu"]
    for argv in (["--config", "DAT"], ["--config", "DAT_fast_teacher", "--ckpt", "x.ckpt"], []):
        with pytest.raises(SystemExit):
            interpolate.main(argv + args)
    assert seen == [(PRESETS["DAT"].config, PRESETS["DAT"].ckpt, "cpu"),
                    (PRESETS["DAT_fast_teacher"].config, "x.ckpt", "cpu"),
                    (DAT_fast, STUDENT, "cpu")]
