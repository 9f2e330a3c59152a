"""The port's DAT and teacher presets and their committed checkpoints against the JAX package (CPU).

Tolerances, as for the shipped student in ``tests/test_torch_dat.py``:
  * fp32 (a float32 copy of each preset on both sides), 128x128, B = 2
    with t = 0.3 and 0.7: 1e-3 max abs and 1e-5 mean abs on the [0, 1]
    frame. The two frameworks sum convolutions in different orders, and
    the differences pass through 40-odd layers.
  * bf16, as the YAMLs have it, on a smooth 64x64 pair: mean abs error at
    most half of JAX's own gap between its bf16 and its fp32 frame on the
    same input.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization as fser

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu_torch import config, interpolate

ROOT = Path(__file__).resolve().parent.parent
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
# preset name -> (its YAML, the checkpoint the repo ships for it)
YAMLS = {"DAT_fast": "configs/DAT_fast.yaml", "DAT": "configs/DAT.yaml",
         "DAT_fast_teacher": "configs/DAT_fast_distill.yaml"}
CKPTS = {"DAT_fast": "tools/quality/results/"
                     "DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.best.ckpt",
         "DAT": "tools/quality/results/DATwConstantnCv1_24k.best.ckpt",
         "DAT_fast_teacher": "configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_config(name: str, **overrides) -> JaxConfig:
    """The JAX ``Config`` of a preset's YAML; for the teacher, the
    distillation YAML with its ``teacher_overrides`` applied."""
    path = ROOT / YAMLS[name]
    if name != "DAT_fast_teacher":
        return JaxConfig.from_yaml(path, **overrides)
    # The YAML refuses to load without a teacher checkpoint.
    cfg = JaxConfig.from_yaml(path, teacher_ckpt=CKPTS[name], **overrides)
    return dataclasses.replace(cfg, **cfg.teacher_overrides)


def _norm(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("name", list(YAMLS))
def test_preset_matches_its_yaml(name):
    preset = config.PRESETS[name]
    ref = jax_config(name)
    for field in dataclasses.fields(preset.config):
        assert _norm(getattr(preset.config, field.name)) == _norm(getattr(ref, field.name)), \
            field.name
    assert preset.ckpt == ROOT / CKPTS[name] and preset.ckpt.is_file()


def _video_pair(h, w, seed):
    """A smooth random texture and its copy shifted by (2, 3) pixels."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, h // 16 + 2, w // 16 + 2), dtype=np.float32))
    tex = F.interpolate(coarse, size=(h + 16, w + 16), mode="bilinear", align_corners=True)
    tex = tex[0].permute(1, 2, 0).numpy()
    return tex[None, 8:8 + h, 8:8 + w].copy(), tex[None, 10:10 + h, 11:11 + w].copy()


def _jax_apply(name, dtype, x0, x1, t):
    model = jax_create_model(jax_config(name, compute_dtype=dtype))
    params = fser.msgpack_restore((ROOT / CKPTS[name]).read_bytes())["params"]
    return np.asarray(jax.jit(model.apply)(params, x0, x1, t))


def _port_apply(cfg, name, x0, x1, t):
    model = interpolate.load_model(cfg, config.PRESETS[name].ckpt, device="cpu")
    with torch.no_grad():
        return model(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t)).numpy()


@pytest.mark.parametrize("name", ["DAT", "DAT_fast_teacher"])
def test_checkpoint_matches_jax_in_fp32_at_batch_2(name):
    rng = np.random.default_rng(11)
    x0 = rng.random((2, 128, 128, 3), dtype=np.float32)
    x1 = np.roll(x0, (2, 3), axis=(1, 2))
    t = np.array([0.3, 0.7], np.float32).reshape(2, 1, 1, 1)
    ref = _jax_apply(name, "float32", x0, x1, t)
    fp32 = dataclasses.replace(config.PRESETS[name].config, compute_dtype="float32")
    out = _port_apply(fp32, name, x0, x1, t)
    err = np.abs(out - ref)
    print(f"{name} 128x128 B=2 fp32: max abs {err.max():.3e}, mean abs {err.mean():.3e}")
    assert out.shape == ref.shape == (2, 128, 128, 3)
    assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL
    # Each item is its own instant: the two frames differ.
    assert np.abs(out[0] - out[1]).mean() > 1e-3


@pytest.mark.parametrize("name", ["DAT", "DAT_fast_teacher"])
def test_checkpoint_matches_jax_in_bf16(name):
    x0, x1 = _video_pair(64, 64, seed=3)
    t = np.full((1, 1, 1, 1), 0.5, np.float32)
    ref = _jax_apply(name, "bfloat16", x0, x1, t)
    ref32 = _jax_apply(name, "float32", x0, x1, t)
    out = _port_apply(config.PRESETS[name].config, name, x0, x1, t)
    gap = np.abs(ref - ref32).mean()
    err = np.abs(out - ref)
    print(f"{name} 64x64 bf16, smooth pair: mean abs {err.mean():.3e} (max {err.max():.3e}) "
          f"against JAX's bf16-vs-fp32 gap {gap:.3e}: {err.mean() / gap:.3f} of it")
    assert out.dtype == np.float32 and out.shape == ref.shape == (1, 64, 64, 3)
    assert err.mean() <= BF16_GAP_SHARE * gap


@pytest.mark.parametrize("name", list(YAMLS))
def test_preset_has_the_jax_evaluation_fields(name):
    """The dataset roots and the checkpoint benchmark the evaluation entry
    point reads, with the JAX config's values (its defaults: no YAML sets
    them)."""
    preset, ref = config.PRESETS[name].config, jax_config(name)
    fields = ("root", "ucf101_root", "snu_root", "save_best_benchmark")
    assert {f: getattr(preset, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert preset.root == "datasets/vimeo_triplet" and preset.snu_root == "datasets/SNU-FILM"
