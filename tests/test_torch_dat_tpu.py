"""DAT-TPU and its local-window attention in the port against the JAX package (CPU, narrow widths).

The blocks at 16 channels on 8x12 maps; the whole model at nf 16 with one
encoder and one decoder block, radii 1/1/1, on 32x48 frames (two pairs);
parameters a flax initialisation plus seeded noise of scale 0.05 (so the
zero-initialised group offsets move), carried to the port by
``interop.params_from_flax``.

Tolerances:
  * the window views and the shifts: exact, in fp32 and bf16;
  * the attention and the block (with perturbed group offsets) in fp32:
    1e-5 absolute (``OP_TOL``); the attention in bf16: mean abs at most
    half of JAX's own bf16-vs-fp32 gap (``BF16_GAP_SHARE``);
  * the whole model in fp32, ``train=False`` and the flow pyramids of
    ``train=True``: 1e-3 max abs and 1e-5 mean abs; in bf16 on a smooth
    pair, half of JAX's own gap;
  * ``dat_loss`` through ``make_loss_fn``: each log term within 1e-5
    relative, the whole gradient within 1e-4 relative in L2;
  * the flax round trip: exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_tiny import jax_init, perturbed, run_in, smooth_pair
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models.dat_tpu import DATwConstantnCTPU as JaxDATTPU
from videoframeinterpolation_tpu.nn import local_attn as jax_local_attn
from videoframeinterpolation_tpu.train.step import make_loss_fn as jax_make_loss_fn
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.models import DATwConstantnCTPU, create_model
from videoframeinterpolation_tpu_torch.nn import local_attn
from videoframeinterpolation_tpu_torch.tools import fixtures, head_to_head
from videoframeinterpolation_tpu_torch.train import make_loss_fn, read_flax_state
from videoframeinterpolation_tpu_torch.train import __main__ as train_cli
from videoframeinterpolation_tpu_torch.utils import logger as port_logger

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "DAT_TPU.yaml"
KW = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1, radii=(1, 1, 1))
B, H, W = 2, 32, 48
OP_TOL = 1e-5
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
DILATED = (-4, -1, 0, 2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)
            for a in arrays]


def _maps(seed, n=3, c=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 8, 12, c)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("radius", [1, 2])
def test_extract_local_windows_matches_jax(radius):
    (x,) = _maps(0, n=1, c=5)
    ref = np.asarray(jax_local_attn.extract_local_windows(x, radius))
    out = local_attn.extract_local_windows(torch.from_numpy(x), radius).numpy()
    assert out.shape == ref.shape == (2, (2 * radius + 1) ** 2, 96, 5)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -2), (-6, 4), (3, 9)])
def test_shift2d_pads_with_the_bias_as_jax_does(dy, dx):
    x, pad = _maps(1, n=1)[0], np.random.default_rng(2).normal(size=(16,)).astype(np.float32)
    for jdt, dtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = jax.jit(jax_local_attn._shift2d, static_argnums=(1, 2))(
            jnp.asarray(x, jdt), dy, dx, jnp.asarray(pad, jdt))
        out = local_attn._shift2d(*_t(x, dtype=dtype), dy, dx, *_t(pad, dtype=dtype))
        assert out.dtype == dtype
        assert np.array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("radius,offsets", [(1, None), (0, DILATED)],
                         ids=["contiguous", "dilated"])
def test_shift_window_attention_matches_jax(radius, offsets):
    q, w0, w1 = _maps(3)
    jmod = jax_local_attn.ShiftWindowSampleAttention(16, radius, 4, offsets_1d=offsets)
    params = perturbed(jax_init(jmod, q, w0, w1), seed=4)
    port = local_attn.ShiftWindowSampleAttention(16, 16, radius, 4, offsets_1d=offsets)
    port.load_state_dict(params_from_flax(params, port))
    assert len(port.shifts) == (2 * radius + 1 if offsets is None else len(offsets)) ** 2
    ref32 = np.asarray(jax.jit(jmod.apply)(params, q, w0, w1))
    with torch.no_grad():
        out = port(*_t(q, w0, w1)).numpy()
    np.testing.assert_allclose(out, ref32, rtol=0, atol=OP_TOL)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, w0, w1)]
    ref16 = np.asarray(jax.jit(jmod.clone(dtype=jnp.bfloat16).apply)(params, *bf), np.float32)
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        out16 = port(*_t(*bf, dtype=torch.bfloat16)).float().numpy()
    gap = np.abs(ref16 - ref32).mean()
    assert gap > 0 and np.abs(out16 - ref16).mean() <= BF16_GAP_SHARE * gap


def test_block_with_perturbed_group_offsets_matches_jax():
    """The block with 4 offset groups and dilated taps, its zero-initialised
    ``conv_group_offset`` perturbed (at zero it would equal the block
    without groups), and its next-level flow head."""
    ft, f0, f1 = _maps(5)
    rng = np.random.default_rng(6)
    fl0, fl1 = (rng.normal(0, 2.0, (2, 8, 12, 2)).astype(np.float32) for _ in range(2))
    kw = dict(radius=0, n_heads=4, offsets_1d=(-2, 0, 2), n_offset_groups=4, offset_scale=2.0)
    jmod = jax_local_attn.LocalWindowCrossAttentionBlock(16, 16, **kw)
    init = jax_init(jmod, ft, f0, f1, fl0, fl1)
    assert not np.asarray(init["params"]["conv_group_offset"]["kernel"]).any()
    params = perturbed(init, seed=7)
    port = local_attn.LocalWindowCrossAttentionBlock(16, 16, **kw)
    port.load_state_dict(params_from_flax(params, port))
    ref = jax.jit(jmod.apply)(params, ft, f0, f1, fl0, fl1)
    with torch.no_grad():
        out = port(*_t(ft, f0, f1, fl0, fl1))
    assert [tuple(o.shape) for o in out] == [(2, 8, 12, 16), (2, 16, 24, 2), (2, 16, 24, 2)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=OP_TOL)


@pytest.fixture(scope="module")
def init():
    x = np.zeros((1, H, W, 3), np.float32)
    return jax_init(JaxDATTPU(**KW), x, x, np.full((1, 1, 1, 1), 0.5, np.float32))


@pytest.fixture(scope="module")
def jax_apply():
    """The JAX model's jitted forward in bf16, and in fp32 with its
    intermediates (``train=True``, whose frame is the ``train=False`` one),
    shared by the tests of this file (each compiles once per shape)."""
    fp32 = jax.jit(lambda p, x0, x1, t: JaxDATTPU(**KW).apply(p, x0, x1, t, train=True))
    return {torch.float32: fp32, torch.bfloat16: jax.jit(JaxDATTPU(**KW).clone(dtype=jnp.bfloat16).apply)}


@pytest.fixture(scope="module")
def params(init):
    return perturbed(init, seed=8)


def _port(params, dtype=torch.float32):
    model = DATwConstantnCTPU(**KW, compute_dtype=dtype)
    model.load_state_dict(params_from_flax(params, model))
    return model


def _batch(seed):
    x0, x1 = smooth_pair(B, H, W, seed)
    rng = np.random.default_rng(seed)
    return {"x0": x0, "x1": x1, "xt": 0.5 * (x0 + x1),
            "t": np.full((B, 1, 1, 1), 0.5, np.float32),
            "f0x": rng.normal(0, 0.02, (B, H, W, 2)).astype(np.float32),
            "f1x": rng.normal(0, 0.02, (B, H, W, 2)).astype(np.float32)}


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax_in_fp32(params, jax_apply, train):
    batch = _batch(9)
    x0, x1, t = batch["x0"], np.roll(batch["x1"], (2, 3), (1, 2)), batch["t"]
    ref = jax_apply[torch.float32](params, x0, x1, t)
    ref = ref if train else ref[0]
    with torch.no_grad():
        out = _port(params)(*_t(x0, x1, t), train=train)
    pairs = [(out, ref)]
    if train:
        assert set(out[1]) == set(ref[1]) == {"pred_ft0", "pred_ft1"}
        pairs = [(out[0], ref[0])] + [(g, r) for k in ("pred_ft0", "pred_ft1")
                                      for g, r in zip(out[1][k], ref[1][k])]
        assert len(pairs) == 9
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())


def test_forward_in_bf16_within_half_of_jaxs_own_gap(params, jax_apply):
    batch = _batch(10)
    x0, x1, t = batch["x0"], batch["x1"], batch["t"]
    ref32 = np.asarray(jax_apply[torch.float32](params, x0, x1, t)[0])
    ref16 = np.asarray(jax_apply[torch.bfloat16](params, x0, x1, t))
    model = _port(params, torch.bfloat16).to(torch.bfloat16)
    with torch.no_grad():
        out = model(*_t(x0, x1, t)).numpy()
    gap = np.abs(ref16 - ref32).mean()
    err = np.abs(out - ref16).mean()
    print(f"DAT-TPU bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
    assert gap > 0 and err <= BF16_GAP_SHARE * gap


def test_loss_terms_and_gradients_match_jax(params):
    batch = _batch(11)
    loss_fn = jax_make_loss_fn(JaxDATTPU(**KW), JaxConfig(model_name="DATwConstantnCTPU"))
    (_, ref_log), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    model = _port(params)
    total, log = make_loss_fn(model, Config(model_name="DATwConstantnCTPU"))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert set(log) == set(ref_log) == {"total_loss", "l1_loss", "census_loss", "flow_loss"}
    for key, value in log.items():
        want = float(ref_log[key])
        assert want > 0 and abs(value.item() - want) <= LOSS_TOL * want, key
    ref = params_from_flax(ref_grads, model)
    # Level 1's movement features feed nothing: JAX's gradient of their
    # parameters is zero, and the port gives them none.
    dead = {k for k, p in model.named_parameters() if not p.requires_grad}
    assert dead and all(k.startswith("dat_lv1.movement_") for k in dead)
    assert all(not ref[k].any() and model.get_parameter(k).grad is None for k in dead)
    got = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                     for _, p in sorted(model.named_parameters())])
    want = torch.cat([ref[k].flatten() for k, _ in sorted(model.named_parameters())])
    err = ((got - want).norm() / want.norm()).item()
    print(f"DAT-TPU loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL


def test_flax_round_trip_is_exact(params):
    model = DATwConstantnCTPU(**KW)
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)


def test_init_follows_the_jax_rules(init):
    """Zero biases, PReLU at 0.25, and the same spread per kernel (std within
    20% for every kernel of 1,000 or more values) as flax's initialisation;
    the group offsets' predictor starts at zero."""
    torch.manual_seed(0)
    model = DATwConstantnCTPU(**KW)
    ref = params_from_flax(init, model)
    for name, p in model.named_parameters():
        r = ref[name]
        if name.endswith("alpha"):
            assert torch.equal(p, r), name
        if name.endswith("bias") or "om_out" in name:
            assert not p.any() and not r.any(), name
        if r.numel() >= 1000 and r.std() > 0:
            assert 0.8 <= (p.std() / r.std()).item() <= 1.25, name
    goff = DATwConstantnCTPU(**KW, n_offset_groups=(2, 4, 4))
    zero = [p for n, p in goff.named_parameters() if "conv_group_offset" in n]
    assert len(zero) == 6 and not any(p.any() for p in zero)


@pytest.mark.parametrize("overrides,count", [
    ({}, 4_541_095),
    ({"n_offset_groups": (4, 8, 8), "offset_sets": head_to_head.OFFSET_SETS}, 4_567_055)],
    ids=["yaml", "dilated_goff"])
def test_full_width_parameter_counts(overrides, count):
    """``configs/DAT_TPU.yaml`` as it stands, and the quality study's dilated
    + group-offset variant: JAX's counts (``jax.eval_shape`` of ``init``;
    the records' ``n_params``)."""
    model = create_model(Config.from_yaml(YAML, **overrides), torch.float32)
    assert isinstance(model, DATwConstantnCTPU) and model.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == count


# ---------------------------------------------------------------------------
# The entry points on configs/DAT_TPU.yaml and the quality-study trainer.

TINY_SETS = ["nf=16", "enc_res_blocks=1", "dec_res_blocks=1", "crop_h=32", "crop_w=32",
             "batch_size=2", "num_workers=1", "num_epochs=1", "compute_dtype=float32",
             "metric_summary_freq=1", "img_summary_freq=2"]


@pytest.fixture(scope="module")
def dat_tpu_run(tmp_path_factory):
    """Two steps of ``python -m videoframeinterpolation_tpu_torch.train`` on
    the YAML at tiny widths, validated after its epoch."""
    base = tmp_path_factory.mktemp("dat_tpu")
    fixtures.write_vimeo90k_train(base, 4, (40, 48), [(32, 48)] * 2, seed=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        torch.set_num_threads(1)
        trainer = run_in(base, train_cli.main, ["--exp_name", "tpu", "--config", str(YAML),
                                                "--device", "cpu",
                                                *[a for kv in TINY_SETS for a in ("--set", kv)]])
    return base, trainer


def test_train_cli_trains_the_yaml(dat_tpu_run):
    base, trainer = dat_tpu_run
    model = trainer.state.model
    assert isinstance(model, DATwConstantnCTPU) and trainer.state.step == 2
    assert [len(getattr(model, f"dat_lv{i}").attn.shifts) for i in (3, 2, 1)] == [25, 25, 49]
    run = base / "exps" / "tpu"
    records = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
               if "train/total_loss" in r]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[f"train/{k}"]) and r[f"train/{k}"] > 0 for r in records
               for k in ("l1_loss", "census_loss", "flow_loss"))
    assert (run / "checkpoints" / "best_vimeo90k.ckpt").is_file()
    assert sorted(p.name for p in (run / "images").iterdir()) == ["flow_0000002.png",
                                                                  "pred_0000002.png"]


def test_evaluate_exp_name_and_interpolate_serve_the_run(dat_tpu_run, tmp_path):
    base, _ = dat_tpu_run
    scores = run_in(base, evaluate.main, ["--exp_name", "tpu", "--device", "cpu"])
    val = [r for r in map(json.loads, (base / "exps" / "tpu" / "metrics.jsonl").read_text()
                          .splitlines()) if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert abs(scores["val/vimeo90k_psnr"] - val[0]["val/vimeo90k/val/vimeo90k_psnr"]) <= 1e-4
    ckpt = str(base / "exps" / "tpu" / "checkpoints" / "best_vimeo90k.ckpt")
    cfg = Config.from_yaml(base / "exps" / "tpu" / "config.yaml")
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    out = tmp_path / "mid.png"
    interpolate.main(["--config", str(base / "exps" / "tpu" / "config.yaml"), "--ckpt", ckpt,
                      "--frame0", str(seq / "im1.png"), "--frame1", str(seq / "im3.png"),
                      "--out", str(out), "--device", "cpu"])
    model = interpolate.load_model(cfg, ckpt, device="cpu")
    frames = [interpolate.read_frame(seq / f) for f in ("im1.png", "im3.png")]
    assert np.array_equal(interpolate.read_frame(out), interpolate.interp_pair(model, *frames))
    # Flow-aware tiling reads DAT-TPU's flow pyramid: a 64x96 pair in 32-px
    # tiles is probed, planned and blended without error.
    big = [np.tile(f, (2, 2, 1)) for f in frames]
    tiled = interpolate.interp_pair(model, *big, infer=interpolate.make_infer(model, 32))
    assert tiled.shape == (64, 96, 3)


def test_head_to_head_trains_the_dilated_group_offset_variant(tmp_path):
    """``--model DATwConstantnCTPU --dilated --goff`` for two steps: the JAX
    tool's tag, events and architecture (OFFSET_SETS taps, 4/8/8 groups)."""
    args = ["--model", "DATwConstantnCTPU", "--dilated", "--goff", "--nf", "16", "--crop", "32",
            "--pool", "4", "--eval_items", "2", "--batch", "2", "--steps", "2", "--chunk", "1",
            "--eval_every", "2", "--warmup", "1", "--device", "cpu",
            "--out_dir", str(tmp_path)]
    out = head_to_head.main(args)
    tag = "DATwConstantnCTPU_dilated_goff_nf16_0k"
    assert out["tag"] == tag
    assert [r["event"] for r in out["records"]] == ["start", "eval", "final"]
    model = out["state"].model
    assert isinstance(model, DATwConstantnCTPU)
    assert [len(getattr(model, f"dat_lv{i}").attn.shifts) for i in (3, 2, 1)] == [25, 49, 81]
    assert [getattr(model, f"dat_lv{i}").n_offset_groups for i in (3, 2, 1)] == [4, 8, 8]
    assert int(read_flax_state(tmp_path / f"{tag}.ckpt")["step"]) == 2
    assert (tmp_path / f"{tag}.jsonl").is_file()
