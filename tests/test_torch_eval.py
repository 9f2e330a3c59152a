"""The port's evaluation against the JAX package's (CPU): metrics, data, pool and protocol.

Tolerances:
  * ``psnr``: 1e-4 dB; ``ssim_3d``: 1e-6. Both are fp32 on both sides; the
    two frameworks sum the mean and the 11x11x11 convolutions in different
    orders.
  * ``SyntheticMotion`` and the held-out pool: equal bytes (the port's copy
    draws from the same ``PCG64([seed, split, index])`` stream).
  * The held-out protocol on a 4-scene 64x64 pool with the shipped student
    in fp32: mean PSNR within 1e-3 dB and mean SSIM within 1e-5 of the
    JAX protocol on the same pool; the model's own fp32 parity (1e-3 max
    abs, ``tests/test_torch_dat.py``) leaves that much room.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.data.synthetic import SyntheticMotion as JaxSyntheticMotion
from videoframeinterpolation_tpu.eval import metrics as jax_metrics
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu_torch.config import PRESETS
from videoframeinterpolation_tpu_torch.data import SyntheticMotion
from videoframeinterpolation_tpu_torch.eval import psnr, ssim_3d
from videoframeinterpolation_tpu_torch.tools import eval_best

ROOT = Path(__file__).resolve().parent.parent
PSNR_TOL = 1e-4
SSIM_TOL = 1e-6
POOL_PSNR_TOL = 1e-3
POOL_SSIM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load_head_to_head():
    spec = importlib.util.spec_from_file_location(
        "head_to_head", ROOT / "tools" / "quality" / "head_to_head.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["head_to_head"] = mod
    spec.loader.exec_module(mod)
    return mod


def _pairs(kind: str, seed: int):
    """Seeded image pairs ``(B, H, W, C)`` in the range that picks each
    branch of ``ssim_3d``'s ``val_range=None``: [0, 1], [0, 255], [-1, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.random((2, 24, 40, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape).astype(np.float32), 0, 1)
    scale, shift = {"unit": (1.0, 0.0), "255": (255.0, 0.0), "signed": (2.0, -1.0)}[kind]
    return a * scale + shift, b * scale + shift


@pytest.mark.parametrize("seed", [1, 2])
def test_psnr_matches_jax(seed):
    a, b = _pairs("unit", seed)
    for j in range(a.shape[0]):
        ours = psnr(torch.from_numpy(a[j]), torch.from_numpy(b[j])).item()
        ref = float(jax_metrics.psnr(jnp.asarray(a[j]), jnp.asarray(b[j])))
        assert abs(ours - ref) <= PSNR_TOL, (ours, ref)


@pytest.mark.parametrize("kind,val_range", [("unit", None), ("255", None), ("signed", None),
                                            ("unit", 1.0), ("255", 255.0)])
def test_ssim_3d_matches_jax(kind, val_range):
    a, b = _pairs(kind, seed=2)
    ours = ssim_3d(torch.from_numpy(a), torch.from_numpy(b), val_range=val_range).item()
    ref = float(jax_metrics.ssim_3d(jnp.asarray(a), jnp.asarray(b), val_range=val_range))
    print(f"ssim_3d {kind} val_range={val_range}: port {ours:.8f}, JAX {ref:.8f}")
    assert abs(ours - ref) <= SSIM_TOL
    assert 0.5 < ours < 1.0


def test_ssim_window_is_the_jax_window():
    from videoframeinterpolation_tpu_torch.eval.metrics import _window_3d
    ours = _window_3d(11)
    ref = jax_metrics._window_3d(11)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("t_kw", [{}, {"fixed_t": 0.25}, {"random_t": True},
                                  {"random_t": (0.125, 0.875)}])
def test_synthetic_motion_gives_the_jax_bytes(is_train, t_kw):
    kw = dict(crop_hw=(48, 80), is_train=is_train, seed=42, num_items=1000, **t_kw)
    ours, ref = SyntheticMotion(**kw), JaxSyntheticMotion(**kw)
    for idx in (0, 3, 517):
        a, b = ours[idx], ref[idx]
        assert set(a) == set(b) == set(eval_best.POOL_KEYS)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (idx, k)


def test_held_out_pool_gives_the_jax_bytes():
    h2h = _load_head_to_head()
    ours = eval_best.build_pool(3, (128, 128), 42, is_train=False)
    ref = h2h.build_pool(3, (128, 128), 42, is_train=False)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    assert ours["x0"].shape == (3, 128, 128, 3) and (ours["t"] == 0.5).all()


def _jax_protocol(pool: dict, name: str) -> tuple[float, float]:
    """``tools/quality/eval_best.py``'s loop: the fp32 model, batches of 8,
    unclipped PSNR and SSIM with ``val_range=1.0`` per item, then the mean."""
    cfg = JaxConfig.from_yaml(ROOT / "configs" / "DAT_fast.yaml", compute_dtype="float32")
    model = jax_create_model(cfg)
    params = fser.msgpack_restore(PRESETS[name].ckpt.read_bytes())["params"]
    infer = jax.jit(lambda p, a, b, t: model.apply(p, a, b, t))
    ps, ss = [], []
    for i in range(0, len(pool["x0"]), 8):
        pred = infer(params, *(jnp.asarray(pool[k][i:i + 8]) for k in ("x0", "x1", "t")))
        gt = jnp.asarray(pool["xt"][i:i + 8])
        for j in range(pred.shape[0]):
            ps.append(float(jax_metrics.psnr(pred[j], gt[j])))
            ss.append(float(jax_metrics.ssim_3d(pred[j:j + 1], gt[j:j + 1], val_range=1.0)))
    return float(np.mean(ps)), float(np.mean(ss))


def test_eval_best_matches_the_jax_protocol():
    (rec,) = eval_best.evaluate(PRESETS["DAT_fast"].config, [PRESETS["DAT_fast"].ckpt],
                                eval_items=4, crop=64, seed=42, device="cpu")
    pool = _load_head_to_head().build_pool(4, (64, 64), 42, is_train=False)
    ref_psnr, ref_ssim = _jax_protocol(pool, "DAT_fast")
    print(f"4-scene 64x64 pool, shipped student fp32: PSNR {rec['psnr']:.6f} vs JAX "
          f"{ref_psnr:.6f}; SSIM {rec['ssim']:.8f} vs JAX {ref_ssim:.8f}")
    assert rec["n"] == 4 and rec["crop"] == 64 and rec["seed"] == 42
    assert rec["step"] == 14500   # the step eval_best.jsonl records for this checkpoint
    assert abs(rec["psnr"] - ref_psnr) <= POOL_PSNR_TOL
    assert abs(rec["ssim"] - ref_ssim) <= POOL_SSIM_TOL


def test_eval_best_cli_prints_and_appends_one_record_per_checkpoint(tmp_path, capsys,
                                                                   monkeypatch):
    calls = []

    def fake_evaluate(cfg, ckpts, eval_items, crop, seed, device):
        calls.append((cfg, list(ckpts), eval_items, crop, seed, device))
        return [{"ckpt": str(c), "step": 7, "psnr": 30.123456, "ssim": 0.9123456, "n": eval_items,
                 "crop": crop, "seed": seed} for c in ckpts]

    monkeypatch.setattr(eval_best, "evaluate", fake_evaluate)
    out = tmp_path / "eval.jsonl"
    eval_best.main(["--config", "DAT", "--eval_items", "2", "--crop", "32", "--device", "cpu",
                    "--out", str(out)])
    eval_best.main(["--config", "DAT", "--ckpt", "a.ckpt", "b.ckpt", "--device", "cpu",
                    "--out", str(out)])
    assert calls[0] == (PRESETS["DAT"].config, [PRESETS["DAT"].ckpt], 2, 32, 42, "cpu")
    assert calls[1][1] == ["a.ckpt", "b.ckpt"] and calls[1][2:5] == (32, 128, 42)
    lines = out.read_text().splitlines()
    assert len(lines) == 3 and capsys.readouterr().out.splitlines() == lines
    rec = json.loads(lines[-1])
    assert list(rec) == ["ckpt", "step", "psnr", "ssim", "n", "crop", "seed"]
    assert rec["ckpt"] == "b.ckpt" and rec["psnr"] == 30.1235 and rec["ssim"] == 0.91235
