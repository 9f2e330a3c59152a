"""IFRNet in the port against the JAX package (CPU, narrow widths).

The model at widths 8/12/16/24 on 32x48 frames (two pairs), its
parameters a flax initialisation plus seeded noise of scale 0.05, carried
to the port by ``interop.params_from_flax``.

Tolerances:
  * ``resize_bilinear(align_corners=False)``, the encoder, a decoder and
    ``geometry_loss`` (value and gradients): 1e-5 absolute (``OP_TOL``;
    the same interpolation matrices and census, summed in another order);
  * the whole model in fp32, ``train=False`` and every intermediate of
    ``train=True``: 1e-3 max abs and 1e-5 mean abs (``MAX_TOL``,
    ``MEAN_TOL``), the whole-model limits of the flagship's tests;
  * in bf16, on a smooth pair: mean abs at most half of JAX's own gap
    between its bf16 and fp32 frames (``BF16_GAP_SHARE``);
  * ``ifrnet_loss`` through ``make_loss_fn``: each log term within 1e-5
    relative (``LOSS_TOL``), the whole gradient within 1e-4 relative in L2
    (``GRAD_TOL``);
  * the flax round trip: exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_tiny import compile_side_by_side, jax_init, perturbed, run_in, smooth_pair
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models.ifrnet import IFRNet as JaxIFRNet
from videoframeinterpolation_tpu.models.ifrnet import _Decoder as JaxDecoder
from videoframeinterpolation_tpu.nn.encoders import IFRNetEncoder as JaxEncoder
from videoframeinterpolation_tpu.ops.interp import resize_bilinear as jax_resize
from videoframeinterpolation_tpu.ops.losses import geometry_loss as jax_geometry_loss
from videoframeinterpolation_tpu.train.step import make_loss_fn as jax_make_loss_fn
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.models import IFRNet, create_model
from videoframeinterpolation_tpu_torch.models.ifrnet import _Decoder
from videoframeinterpolation_tpu_torch.nn import IFRNetEncoder
from videoframeinterpolation_tpu_torch.ops import bwarp, geometry_loss, resize_bilinear
from videoframeinterpolation_tpu_torch.ops.warp import base_grid
from videoframeinterpolation_tpu_torch.tools import fixtures
from videoframeinterpolation_tpu_torch.train import make_loss_fn
from videoframeinterpolation_tpu_torch.train import __main__ as train_cli
from videoframeinterpolation_tpu_torch.train.trainer import build_dataset
from videoframeinterpolation_tpu_torch.utils import logger as port_logger

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "IFRNet.yaml"
CH = (8, 12, 16, 24)
B, H, W = 2, 32, 48
OP_TOL = 1e-5
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def init():
    x = np.zeros((1, H, W, 3), np.float32)
    return jax_init(JaxIFRNet(channels=CH), x, x, np.full((1, 1, 1, 1), 0.5, np.float32))


@pytest.fixture(scope="module")
def jax_apply(params):
    """The JAX model's jitted forward in bf16, and in fp32 with its
    intermediates (``train=True``, whose frame is the ``train=False`` one),
    at the tests' ``(B, H, W)`` frames, and the value and gradient of its
    training loss (``train/step.py``'s recipe) on a batch of them, compiled
    side by side and shared by the tests of this file."""
    batch = _batch()
    x = (batch["x0"], batch["x1"], batch["t"])
    loss_fn = jax_make_loss_fn(JaxIFRNet(channels=CH), JaxConfig(model_name="IFRNet"))
    fp32, bf16, loss = compile_side_by_side(
        (lambda p, x0, x1, t: JaxIFRNet(channels=CH).apply(p, x0, x1, t, train=True),
         (params, *x)),
        (JaxIFRNet(channels=CH).clone(dtype=jnp.bfloat16).apply, (params, *x)),
        (jax.value_and_grad(loss_fn, has_aux=True), (params, batch)))
    return {torch.float32: fp32, torch.bfloat16: bf16, "loss": loss}


@pytest.fixture(scope="module")
def params(init):
    return perturbed(init, seed=1)


def _batch(seed=0):
    x0, x1 = smooth_pair(B, H, W, seed)
    rng = np.random.default_rng(seed)
    return {"x0": x0, "x1": x1, "xt": 0.5 * (x0 + x1),
            "t": np.full((B, 1, 1, 1), 0.5, np.float32),
            "f0x": rng.normal(0, 1.0, (B, H, W, 2)).astype(np.float32),
            "f1x": rng.normal(0, 1.0, (B, H, W, 2)).astype(np.float32)}


def _port(params, dtype=torch.float32):
    model = IFRNet(CH, compute_dtype=dtype)
    model.load_state_dict(params_from_flax(params, model))
    return model


@pytest.mark.parametrize("hw,out_hw", [((8, 12), (16, 24)), ((4, 6), (32, 48)),
                                       ((16, 24), (8, 12)), ((7, 9), (5, 13))])
def test_resize_bilinear_without_aligned_corners_matches_jax(hw, out_hw):
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    for align in (False, True):
        ref = np.asarray(jax_resize(x, out_hw, align_corners=align))
        out = resize_bilinear(torch.from_numpy(x), out_hw, align_corners=align).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=OP_TOL)


def test_geometry_loss_and_both_gradients_match_jax():
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(2, 10, 12, 5)).astype(np.float32) for _ in range(2))
    ref, (gx, gy) = jax.jit(jax.value_and_grad(jax_geometry_loss, argnums=(0, 1)))(x, y)
    tx, ty = (a.requires_grad_() for a in _t(x, y))
    loss = geometry_loss(tx, ty)
    loss.backward()
    assert abs(loss.item() - float(ref)) <= OP_TOL * abs(float(ref))
    assert tx.grad.abs().max() > 0 and ty.grad.abs().max() > 0   # neither side detached
    for got, want in ((tx.grad, gx), (ty.grad, gy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=OP_TOL * np.abs(want).max())


def test_encoder_matches_jax(params):
    x = np.random.default_rng(2).normal(size=(B, H, W, 3)).astype(np.float32)
    ref = JaxEncoder(CH).apply({"params": params["params"]["encoder"]}, x)
    enc = IFRNetEncoder(CH)
    enc.load_state_dict(params_from_flax(params["params"]["encoder"], enc))
    with torch.no_grad():
        out = enc(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [(B, H // 2 ** i, W // 2 ** i, c)
                                             for i, c in zip((1, 2, 3, 4), CH)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=OP_TOL)


def test_decoder_matches_jax(params):
    c3, c2 = CH[2], CH[1]
    x = np.random.default_rng(3).normal(size=(B, 4, 6, 3 * c3 + 4)).astype(np.float32)
    sub = params["params"]["decoder3"]
    ref = JaxDecoder(3 * c3, 4 + c2).apply({"params": sub}, x)
    dec = _Decoder(3 * c3 + 4, 3 * c3, 4 + c2)
    dec.load_state_dict(params_from_flax(sub, dec))
    assert dec.resblock.side == min(32, 3 * c3 // 2) and not dec.resblock.final_activation
    with torch.no_grad():
        out = dec(torch.from_numpy(x))
    assert out.shape == (B, 8, 12, 4 + c2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=OP_TOL)


INTERMEDIATES = {"flows0", "flows1", "feats_t", "mask", "x0_warp", "x1_warp", "mean"}


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax_in_fp32(params, jax_apply, train):
    batch = _batch(seed=4)
    x0, x1, t = batch["x0"], np.roll(batch["x1"], (2, 3), (1, 2)), batch["t"]
    ref = jax_apply[torch.float32](params, x0, x1, t)
    ref = ref if train else ref[0]
    with torch.no_grad():
        out = _port(params)(*_t(x0, x1, t), train=train)
    pairs = [(out, ref)] if not train else [(out[0], ref[0])]
    if train:
        assert set(out[1]) == set(ref[1]) == INTERMEDIATES
        for key in INTERMEDIATES:
            got, want = out[1][key], ref[1][key]
            got, want = (got, want) if isinstance(got, list) else ([got], [want])
            assert len(got) == len(want)
            pairs += list(zip(got, want))
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())


def test_forward_in_bf16_within_half_of_jaxs_own_gap(params, jax_apply):
    batch = _batch(seed=5)
    x0, x1, t = batch["x0"], batch["x1"], batch["t"]
    ref32 = np.asarray(jax_apply[torch.float32](params, x0, x1, t)[0])
    ref16 = np.asarray(jax_apply[torch.bfloat16](params, x0, x1, t))
    with torch.no_grad():
        out = _port(params, torch.bfloat16).to(torch.bfloat16)(*_t(x0, x1, t)).numpy()
    gap = np.abs(ref16 - ref32).mean()
    err = np.abs(out - ref16).mean()
    print(f"IFRNet bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
    assert gap > 0 and err <= BF16_GAP_SHARE * gap


def test_loss_terms_and_gradients_match_jax(params, jax_apply):
    batch = _batch(seed=6)
    (_, ref_log), ref_grads = jax_apply["loss"](params, batch)
    model = _port(params)
    total, log = make_loss_fn(model, Config(model_name="IFRNet"))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert set(log) == set(ref_log) == {"total_loss", "l1_loss", "census_loss", "flow_loss",
                                        "geometry_loss"}
    for key, value in log.items():
        want = float(ref_log[key])
        assert want > 0 and abs(value.item() - want) <= LOSS_TOL * want, key
    ref = params_from_flax(ref_grads, model)
    got = torch.cat([p.grad.flatten() for _, p in sorted(model.named_parameters())])
    want = torch.cat([ref[k].flatten() for k, _ in sorted(model.named_parameters())])
    err = ((got - want).norm() / want.norm()).item()
    print(f"IFRNet loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL


def test_distill_lambda_null_reads_as_zero(params):
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=6).items()}
    model = _port(params)
    _, log = make_loss_fn(model, Config(model_name="IFRNet", distill_lambda=None))(batch)
    _, log1 = make_loss_fn(model, Config(model_name="IFRNet"))(batch)
    assert log["flow_loss"].item() == 0.0 and log1["flow_loss"].item() > 0
    assert log["geometry_loss"].item() == log1["geometry_loss"].item() > 0


def test_flax_round_trip_is_exact(params):
    model = IFRNet(CH)
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)


def test_init_follows_the_jax_rules(init):
    """Zero biases, PReLU at 0.25 and the same spread per kernel (std within
    20% for every kernel of 1,000 or more values) as flax's initialisation."""
    torch.manual_seed(0)
    model = IFRNet(CH)
    ref = params_from_flax(init, model)
    for name, p in model.named_parameters():
        r = ref[name]
        if name.endswith("alpha"):
            assert torch.equal(p, r), name
        if name.endswith("bias"):
            assert not p.any() and not r.any(), name
        if r.numel() >= 1000:
            assert 0.8 <= (p.std() / r.std()).item() <= 1.25, name


def test_full_width_parameter_count():
    """``configs/IFRNet.yaml`` as it stands: the JAX count (``jax.eval_shape``
    of ``init``; ``BENCH_SUITE.json``'s ``n_params``)."""
    model = create_model(Config.from_yaml(YAML), torch.float32)
    assert isinstance(model, IFRNet) and model.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == 4_959_044


# ---------------------------------------------------------------------------
# The data and the entry points on configs/IFRNet.yaml.

TREE = dict(n_train=4, train_hw=(40, 48), test_hws=[(32, 48)] * 2, seed=9)
FLOW_DIR = "gmflow_scale2_refine6"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("ifrnet")
    fixtures.write_vimeo90k_train(base, TREE["n_train"], TREE["train_hw"], TREE["test_hws"],
                                  TREE["seed"], flow_dir=FLOW_DIR)
    return base


def test_training_batch_reads_forward_flows_in_their_direction(tree):
    """IFRNet's config reads ``flow_01.npy`` / ``flow_10.npy`` (``distill_bwd:
    false``), swapped with the frames and augmented with them: ``x1`` sampled
    at ``p + f0x(p)`` gives ``x0`` away from occlusions, and ``x0`` at ``p +
    f1x(p)`` gives ``x1``. The flows reach the batch scaled by 1/255, the
    reference's unit quirk that JAX keeps."""
    cfg = Config.from_yaml(YAML, root=str(tree / "datasets" / "vimeo_triplet"), crop_h=32,
                           crop_w=48)
    assert (cfg.flow_dir, cfg.distill_bwd) == (FLOW_DIR, False)
    ds = build_dataset(cfg)
    for i in range(len(ds)):
        item = {k: torch.from_numpy(v)[None] for k, v in ds[i].items()}
        for src, dst, flow in (("x1", "x0", "f0x"), ("x0", "x1", "f1x")):
            f = item[flow] * 255.0
            assert f.abs().max() > 2.0
            # Pixels whose surface leaves the frame have nothing to match.
            to = base_grid(*f.shape[1:3], f.device) + f
            inside = ((to >= 0) & (to <= torch.tensor([f.shape[2] - 1, f.shape[1] - 1]))).all(-1)
            err, wrong, still = ((a - item[dst]).abs().mean(-1)[inside].median()
                                 for a in (bwarp(item[src], f), bwarp(item[src], -f), item[src]))
            assert err < 0.2 * min(wrong, still), (i, flow, err, wrong, still)


@pytest.fixture(scope="module")
def ifrnet_run(tree):
    """Two steps of ``python -m videoframeinterpolation_tpu_torch.train`` on
    the YAML (fp32, crop 32, batch 2), validated after its epoch."""
    sets = ["crop_h=32", "crop_w=32", "batch_size=2", "num_workers=1", "num_epochs=1",
            "compute_dtype=float32", "metric_summary_freq=1", "img_summary_freq=2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        torch.set_num_threads(1)
        trainer = run_in(tree, train_cli.main, ["--exp_name", "ifr", "--config", str(YAML),
                                                "--device", "cpu",
                                                *[a for kv in sets for a in ("--set", kv)]])
    return tree, trainer


def test_train_cli_trains_the_yaml(ifrnet_run):
    base, trainer = ifrnet_run
    assert isinstance(trainer.state.model, IFRNet) and trainer.state.step == 2
    assert trainer.num_params == 4_959_044
    run = base / "exps" / "ifr"
    records = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
               if "train/total_loss" in r]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[f"train/{k}"]) and r[f"train/{k}"] > 0 for r in records
               for k in ("l1_loss", "census_loss", "flow_loss", "geometry_loss"))
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "best_vimeo90k.ckpt", "best_vimeo90k.meta.json"]
    # The flow strip of a model without a flow pyramid: the pseudo-GT pair.
    assert sorted(p.name for p in (run / "images").iterdir()) == ["flow_0000002.png",
                                                                  "pred_0000002.png"]


def test_evaluate_exp_name_scores_the_run(ifrnet_run):
    base, trainer = ifrnet_run
    scores = run_in(base, evaluate.main, ["--exp_name", "ifr", "--device", "cpu"])
    val = [r for r in map(json.loads, (base / "exps" / "ifr" / "metrics.jsonl").read_text()
                          .splitlines()) if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert abs(scores["val/vimeo90k_psnr"] - val[0]["val/vimeo90k/val/vimeo90k_psnr"]) <= 1e-4


def test_interpolate_serves_the_yaml_and_refuses_to_tile_it(ifrnet_run, tmp_path):
    base, _ = ifrnet_run
    ckpt = str(base / "exps" / "ifr" / "checkpoints" / "best_vimeo90k.ckpt")
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    pair = ["--frame0", str(seq / "im1.png"), "--frame1", str(seq / "im3.png")]
    out = tmp_path / "mid.png"
    interpolate.main(["--config", str(YAML), "--ckpt", ckpt, *pair, "--out", str(out),
                      "--device", "cpu"])
    model = interpolate.load_model(Config.from_yaml(YAML), ckpt, device="cpu")
    assert model.dtype == torch.bfloat16   # the YAML's dtype
    want = interpolate.interp_pair(model, *(interpolate.read_frame(seq / f)
                                            for f in ("im1.png", "im3.png")))
    assert np.array_equal(interpolate.read_frame(out), want)
    with pytest.raises(SystemExit, match="needs --ckpt"):
        interpolate.main(["--config", str(YAML), *pair, "--out", str(out), "--device", "cpu"])
    with pytest.raises(SystemExit, match="IFRNet returns none"):
        interpolate.main(["--config", str(YAML), "--ckpt", ckpt, *pair, "--out", str(out),
                          "--tile", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="IFRNet returns none"):
        run_in(base, evaluate.main, ["--exp_name", "ifr", "--tile", "16", "--device", "cpu"])
    with pytest.raises(ValueError, match="no staged encode/decode"):
        interpolate.upsample_sequence(model, [want] * 3, 4, mode="direct")
