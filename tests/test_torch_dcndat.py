"""DCNDAT in the port against the JAX package (CPU, narrow widths), and its entry points on ``configs/archive/DCNDAT.yaml``.

A tiny DCNDAT (nf 16, one encoder and one decoder block) on 64x64 frames
(two pairs), its parameters the port's initialisation plus seeded noise of
scale 0.05, written by the port's checkpoint writer and read by JAX (no
flax ``init`` runs). Every JAX call is jitted once and shared: one fp32
``value_and_grad`` of the training loss, whose aux carries the frame and
the intermediates, and one bf16 forward, the two compiled side by side.

Tolerances:
  * fp32, the frame and every intermediate (``feat_t_3``, ``feat_t_4``,
    the eight flows, ``mean``): 1e-3 max abs and 1e-5 mean abs;
  * bf16 on a smooth pair: mean abs at most half of JAX's own
    bf16-vs-fp32 gap (``BF16_GAP_SHARE``). With identical bf16 inputs a
    level-3 block is bit-exact; what remains are rounding flips where the
    two frameworks' fp32 convolution sums straddle a bf16 boundary. At a
    noise scale of 0.1 the tiny model is chaotic in bf16 (the flips grow
    to 0.55-0.86 of the gap over three parameter seeds and three pairs;
    0.06-0.15 at 0.05);
  * the loss: each log term within 1e-5 relative, the whole gradient
    within 1e-4 relative in L2 (as DAT-TPU in ``test_torch_dat_tpu.py``);
  * XLA's bf16 ``res + ftx`` (one sum, two consumers that cast it to fp32):
    both consumers bit-exact with the port's fp32 sum;
  * the flax round trip: exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from torch_tiny import compile_side_by_side, run_in, smooth_pair, write_tiny_checkpoint
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models.dcndat import DCNDAT as JaxDCNDAT
from videoframeinterpolation_tpu.models.dcndat import DCNDATBlock as JaxDCNDATBlock
from videoframeinterpolation_tpu.models.dcndat import dcndat_loss as jax_dcndat_loss
from videoframeinterpolation_tpu.nn.deformable_attn import (
    _grouped_deformable_sample as jax_grouped_sample)
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.kernels import deformable_sample
from videoframeinterpolation_tpu_torch.models import DCNDAT, create_model, multi_t_apply
from videoframeinterpolation_tpu_torch.nn.blocks import _fan_in
from videoframeinterpolation_tpu_torch.tools import fixtures
from videoframeinterpolation_tpu_torch.train import make_loss_fn, read_flax_msgpack
from videoframeinterpolation_tpu_torch.train import __main__ as train_cli
from videoframeinterpolation_tpu_torch.train.trainer import build_dataset
from videoframeinterpolation_tpu_torch.utils import logger as port_logger

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "archive" / "DCNDAT.yaml"
KW = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1)
TINY = Config.from_yaml(YAML, compute_dtype="float32", **KW)
NOISE = 0.05
B, H, W = 2, 64, 64
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The checkpoint (written by the port), JAX's parameters read from it,
    and a seeded batch: a smooth pair, its mean as the ground truth, and
    pseudo-GT flows."""
    ckpt = write_tiny_checkpoint(tmp_path_factory.mktemp("dcndat") / "tiny.ckpt", seed=0,
                                 cfg=TINY, scale=NOISE)
    params = fser.msgpack_restore(ckpt.read_bytes())["params"]
    x0, x1 = smooth_pair(B, H, W, seed=12)
    rng = np.random.default_rng(13)
    batch = {"x0": x0, "x1": x1, "xt": 0.5 * (x0 + x1),
             "t": np.full((B, 1, 1, 1), 0.5, np.float32),
             "f0x": rng.normal(0, 0.02, (B, H, W, 2)).astype(np.float32),
             "f1x": rng.normal(0, 0.02, (B, H, W, 2)).astype(np.float32)}
    return ckpt, params, batch


@pytest.fixture(scope="module")
def jax_calls(tiny):
    """JAX's two calls on the tiny model, compiled side by side: the fp32
    training loss (``train/step.py``'s DCNDAT branch) with its gradient,
    the log, the frame and the intermediates in its aux; and the bf16
    forward."""
    _, params, batch = tiny
    model = JaxDCNDAT(**KW)

    def loss_fn(p, b):
        pred, inter = model.apply(p, b["x0"], b["x1"], b["t"], train=True)
        total, log = jax_dcndat_loss(model, p, pred, inter, b, geo_lambda=TINY.geo_lambda,
                                     distill_lambda=TINY.distill_lambda)
        return total, (log, pred, inter)

    x = [batch[k] for k in ("x0", "x1", "t")]
    return compile_side_by_side((jax.value_and_grad(loss_fn, has_aux=True), (params, batch)),
                                (JaxDCNDAT(**KW, dtype=jnp.bfloat16).apply, (params, *x)))


@pytest.fixture(scope="module")
def jax_fp32(tiny, jax_calls):
    """JAX's fp32 loss, in its aux the log, the frame and the
    intermediates, and its gradient."""
    _, params, batch = tiny
    (_, aux), grads = jax_calls[0](params, batch)
    return jax.tree_util.tree_map(np.asarray, aux), grads


def _port(ckpt, dtype="float32"):
    """The tiny model served from the checkpoint, as ``interpolate`` loads it."""
    cfg = Config.from_yaml(YAML, compute_dtype=dtype, **KW)
    return interpolate.load_model(cfg, ckpt, device="cpu")


def test_forward_and_intermediates_match_jax_in_fp32(tiny, jax_fp32):
    ckpt, _, batch = tiny
    (_, ref_pred, ref_inter), _ = jax_fp32
    model = _port(ckpt)
    x = [torch.from_numpy(batch[k]) for k in ("x0", "x1", "t")]
    with torch.no_grad():
        pred, inter = model(*x, train=True)
        assert torch.equal(model(*x), pred)
    assert set(inter) == set(ref_inter) == {"feat_t_3", "feat_t_4", "flows0", "flows1", "mean"}
    pairs = [(pred, ref_pred)] + [(inter[k], ref_inter[k]) for k in ("feat_t_3", "feat_t_4",
                                                                     "mean")]
    for key in ("flows0", "flows1"):
        assert [tuple(f.shape) for f in inter[key]] == [(B, H // s, W // s, 2)
                                                        for s in (2, 4, 8, 16)]
        pairs += list(zip(inter[key], ref_inter[key]))
    assert len(pairs) == 12
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())
    # The flows move: the offsets and residual flows are not at their zero init.
    assert min(np.abs(f).max() for f in ref_inter["flows0"]) > 0.05


def test_forward_in_bf16_within_half_of_jaxs_own_gap(tiny, jax_calls, jax_fp32):
    ckpt, params, batch = tiny
    (_, ref32, _), _ = jax_fp32
    x = [batch[k] for k in ("x0", "x1", "t")]
    ref16 = np.asarray(jax_calls[1](params, *x))
    model = _port(ckpt, "bfloat16")
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(*map(torch.from_numpy, x)).numpy()
    gap = np.abs(ref16 - ref32).mean()
    err = np.abs(out - ref16).mean()
    print(f"DCNDAT bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
    assert out.dtype == np.float32 and out.shape == ref16.shape == (B, H, W, 3)
    assert gap > 0 and err <= BF16_GAP_SHARE * gap


def test_loss_terms_and_gradients_match_jax(tiny, jax_fp32):
    ckpt, _, batch = tiny
    (ref_log, _, _), ref_grads = jax_fp32
    model = create_model(TINY, torch.float32)
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    total, log = make_loss_fn(model, TINY)(_torch(batch))
    total.backward()
    assert set(log) == set(ref_log) == {"total_loss", "l1_loss", "census_loss",
                                        "geometry_loss", "flow_loss"}
    for key, value in log.items():
        want = float(ref_log[key])
        assert want > 0 and abs(value.item() - want) <= LOSS_TOL * want, key
    ref = params_from_flax(ref_grads, model)
    assert all(p.grad is not None for p in model.parameters())
    got = torch.cat([p.grad.flatten() for _, p in sorted(model.named_parameters())])
    want = torch.cat([ref[k].flatten() for k, _ in sorted(model.named_parameters())])
    err = ((got - want).norm() / want.norm()).item()
    print(f"DCNDAT loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL


def test_offsets_sum_is_taken_in_fp32_by_both_consumers(tiny):
    """JAX forms ``offsets = res + ftx`` in bf16 and hands it to the
    deformable conv and the sampler, each of which casts it to fp32. XLA
    fuses the sum into each consumer without rounding it: both equal the
    port's, which sums in fp32, bit for bit; rounding the sum first does
    not."""
    _, params, _ = tiny
    rng = np.random.default_rng(14)
    feat = rng.normal(size=(B, 8, 8, 16)).astype(np.float32)
    ftx = rng.normal(0, 2.0, (B, 8, 8, 2)).astype(np.float32)
    mv = rng.normal(size=(B, 8, 8, 16)).astype(np.float32)

    def consumers(block, feat, ftx, mv):
        off, mask = block._offsets_mask(ftx, mv)
        return block.query_enhancer(feat, off, mask), jax_grouped_sample(feat, off, block.n_groups)

    jblock = JaxDCNDATBlock(16, 16, n_samples=9, n_groups=8, n_heads=8, dtype=jnp.bfloat16)
    ref = jax.jit(lambda p, *a: jblock.apply(p, *a, method=consumers))(
        {"params": params["params"]["dat_scale3"]},
        *(jnp.asarray(a, jnp.bfloat16) for a in (feat, ftx, mv)))
    ref = [np.asarray(r, np.float32) for r in ref]
    block = _port(tiny[0], "bfloat16").dat_scale3
    feat_b, ft_b, mv_b = (torch.from_numpy(a).bfloat16() for a in (feat, ftx, mv))
    with torch.no_grad():
        got = block._enhance_and_sample(feat_b, ft_b, mv_b)
        assert [np.array_equal(g.float().numpy(), r) for g, r in zip(got, ref)] == [True, True]
        # The other reading: the sum rounded to bf16, then handed to both.
        om = block.conv_res_offset_mask(mv_b).reshape(B, 8, 8, 8, 3, 9)
        res = 2.0 * torch.tanh(torch.stack([om[..., 0, :], om[..., 1, :]], dim=-1))
        rounded = res + ft_b[:, :, :, None, None, :]
        alt = (block.query_enhancer(feat_b, rounded, om[..., 2, :]),
               deformable_sample(feat_b, torch.zeros_like(ft_b), rounded.contiguous(), 8))
    assert not any(np.array_equal(a.float().numpy(), r) for a, r in zip(alt, ref))


def test_flax_round_trip_is_exact(tiny):
    _, params, _ = tiny
    model = DCNDAT(**KW)
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)


def test_full_width_model_from_the_yaml():
    """``configs/archive/DCNDAT.yaml`` (``model_name: DCNDATv1``) builds the
    port's DCNDAT in bf16 with JAX's parameter tree: the same names and
    shapes as ``jax.eval_shape`` of the JAX model's ``init``, 3,687,061
    parameters."""
    cfg = Config.from_yaml(YAML)
    assert cfg.model_name == "DCNDATv1"
    model = create_model(cfg, torch.float32)
    assert isinstance(model, DCNDAT) and model.dtype == torch.bfloat16
    assert isinstance(create_model(Config.from_yaml(YAML, model_name="DCNDAT")), DCNDAT)
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmodel = jax_create_model(JaxConfig.from_yaml(YAML))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), x, x, np.zeros((1, 1, 1, 1)))
    ref = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    ours = params_to_flax(dict(model.named_parameters()), model)
    assert ref == {jax.tree_util.keystr(k): v.shape
                   for k, v in jax.tree_util.tree_leaves_with_path(ours)}
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in ref.values()) == 3_687_061


def test_init_follows_the_jax_rules():
    """At full width, each parameter drawn by its JAX counterpart's rule
    (``nn/blocks.py:23-26``, ``models/dcndat.py:68-72``, flax's ``Dense``):
    zero biases and offset-and-mask predictors, PReLU at 0.25, the grouped
    DCN weights ``U(+-(Cin/G * 9)^-1/2)``, the query blender's kernel
    ``lecun_normal`` (truncated at two standard deviations), the residual
    blocks' kernels ``N(0, 0.02 / fan_in)`` and every other kernel
    ``U(+-fan_in^-1/2)``: each kernel of 1,000 or more values within its
    bound and with a std within 20% of its rule's."""
    torch.manual_seed(0)
    model = create_model(Config.from_yaml(YAML), torch.float32)
    modules = dict(model.named_modules())
    seen = set()
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf == "alpha":
            assert torch.all(p == 0.25), name
            continue
        if leaf == "bias" or owner.endswith(("conv_res_offset_mask", "om_out")):
            assert not p.any(), name
            continue
        if owner.endswith(("query_enhancer", ".dcn")):
            G, KK, Cg, _ = p.shape
            bound, std = (Cg * KK) ** -0.5, (Cg * KK) ** -0.5 / 3 ** 0.5
            rule = "dcn"
        elif owner.endswith("query_blender"):
            std = _fan_in(modules[owner]) ** -0.5
            bound, rule = 2 * std / 0.87962566103423978, "lecun"
        elif ".block" in owner:
            std = (0.02 / _fan_in(modules[owner])) ** 0.5
            bound, rule = 10 * std, "res"
        else:
            bound = _fan_in(modules[owner]) ** -0.5
            std, rule = bound / 3 ** 0.5, "torch"
        seen.add(rule)
        assert p.abs().max() <= bound, name
        if p.numel() >= 1000:
            assert 0.8 <= p.std().item() / std <= 1.25, (name, p.std().item(), std)
    assert seen == {"dcn", "lecun", "res", "torch"}


# ---------------------------------------------------------------------------
# The entry points on configs/archive/DCNDAT.yaml.

TINY_SETS = ["data_name=Vimeo90KwFlow", "nf=16", "enc_res_blocks=1", "dec_res_blocks=1",
             "crop_h=32", "crop_w=32", "batch_size=2", "num_workers=1", "num_epochs=1",
             "compute_dtype=float32", "metric_summary_freq=1", "img_summary_freq=2"]


@pytest.fixture(scope="module")
def dcndat_run(tmp_path_factory):
    """Two steps of ``python -m videoframeinterpolation_tpu_torch.train`` on
    the YAML at tiny widths, validated after its epoch. The YAML names
    ``data_name: Vimeo90K``, whose batches carry no flows for its
    ``distill_lambda``: the run sets ``Vimeo90KwFlow``, which reads the
    YAML's ``flow_dir`` and ``distill_bwd`` (its t->0 and t->1 flows)."""
    base = tmp_path_factory.mktemp("dcndat_run")
    fixtures.write_vimeo90k_train(base, 4, (40, 48), [(32, 48)] * 2, seed=17)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        torch.set_num_threads(1)
        trainer = run_in(base, train_cli.main, ["--exp_name", "dcn", "--config", str(YAML),
                                                "--device", "cpu",
                                                *[a for kv in TINY_SETS for a in ("--set", kv)]])
    return base, trainer


def test_train_cli_trains_the_yaml(dcndat_run):
    base, trainer = dcndat_run
    # The YAML's own Vimeo90K gives batches without flows: the loss says so.
    cfg = Config.from_yaml(YAML, root=str(base / "datasets" / "vimeo_triplet"), crop_h=32,
                           crop_w=32, compute_dtype="float32", **KW)
    item = {k: torch.from_numpy(v)[None] for k, v in build_dataset(cfg)[0].items()}
    assert "f0x" not in item
    with pytest.raises(ValueError, match="data_name Vimeo90KwFlow"):
        make_loss_fn(create_model(cfg), cfg)(item)
    assert isinstance(trainer.state.model, DCNDAT) and trainer.state.step == 2
    run = base / "exps" / "dcn"
    cfg = Config.from_yaml(run / "config.yaml")
    assert (cfg.model_name, cfg.data_name, cfg.flow_dir, cfg.distill_bwd) == (
        "DCNDATv1", "Vimeo90KwFlow", "flow", True)
    records = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
               if "train/total_loss" in r]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[f"train/{k}"]) and r[f"train/{k}"] > 0 for r in records
               for k in ("l1_loss", "census_loss", "geometry_loss", "flow_loss"))
    assert (run / "checkpoints" / "best_vimeo90k.ckpt").is_file()
    assert sorted(p.name for p in (run / "images").iterdir()) == ["flow_0000002.png",
                                                                  "pred_0000002.png"]


def test_evaluate_and_interpolate_serve_the_run(dcndat_run, tmp_path):
    """``evaluate --exp_name`` gives the trainer's validation score;
    ``interpolate`` serves the run's checkpoint in pair and in recursive
    sequence mode, and refuses ``--tile`` and ``--mode direct``."""
    base, _ = dcndat_run
    scores = run_in(base, evaluate.main, ["--exp_name", "dcn", "--device", "cpu"])
    val = [r for r in map(json.loads, (base / "exps" / "dcn" / "metrics.jsonl").read_text()
                          .splitlines()) if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert abs(scores["val/vimeo90k_psnr"] - val[0]["val/vimeo90k/val/vimeo90k_psnr"]) <= 1e-4
    config = str(base / "exps" / "dcn" / "config.yaml")
    ckpt = str(base / "exps" / "dcn" / "checkpoints" / "best_vimeo90k.ckpt")
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    pair = ["--frame0", str(seq / "im1.png"), "--frame1", str(seq / "im3.png")]
    interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                      str(tmp_path / "mid.png"), "--device", "cpu"])
    model = interpolate.load_model(Config.from_yaml(config), ckpt, device="cpu")
    frames = [interpolate.read_frame(seq / f) for f in ("im1.png", "im2.png", "im3.png")]
    mid = interpolate.interp_pair(model, frames[0], frames[2])
    assert np.array_equal(interpolate.read_frame(tmp_path / "mid.png"), mid)

    (tmp_path / "in").mkdir()
    for i, f in enumerate(frames):
        interpolate.write_frame(tmp_path / "in" / f"{i}.png", f)
    interpolate.main(["--config", config, "--ckpt", ckpt, "--in_dir", str(tmp_path / "in"),
                      "--out_dir", str(tmp_path / "out"), "--factor", "2", "--device", "cpu"])
    written = sorted((tmp_path / "out").iterdir())
    assert [p.name for p in written] == [f"{i:06d}.png" for i in range(5)]
    assert np.array_equal(interpolate.read_frame(written[1]),
                          interpolate.interp_pair(model, frames[0], frames[1]))

    with pytest.raises(SystemExit, match="DCNDAT returns none"):
        interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                          str(tmp_path / "t.png"), "--tile", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="DCNDAT returns none"):
        run_in(base, evaluate.main, ["--exp_name", "dcn", "--tile", "16", "--device", "cpu"])
    with pytest.raises(ValueError, match="no staged encode/decode"):
        interpolate.upsample_sequence(model, frames, 4, mode="direct")
    with pytest.raises(ValueError, match="no staged encode/decode"):
        multi_t_apply(model, *(torch.zeros(1, 32, 32, 3),) * 2, [0.5])
