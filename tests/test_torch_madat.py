"""MADAT in the port against the JAX package (CPU, narrow widths), and its entry points on ``configs/archive/MADAT.yaml``.

The new modules (``nn/madat.py``: the normalised coordinate grid,
``DWConvMlp``, ``InterFrameAttention``, ``FlowSelfAttnPropagation`` and
``DATWithMotionEstimation`` at both of MADAT's group widths, on the
sampler's plain version) on seeded inputs, and a tiny MADAT (channels
8/16/16, depths 1/1/1, motion_dim 16, mlp_ratio 2) on two 64x64 pairs.
The tiny model's parameters are the port's initialisation plus seeded
noise of scale 0.05, written by the port's checkpoint writer and read by
JAX (no flax ``init`` runs). At that scale the tiny model's bf16 frame is
at its chaos floor: JAX's own frame moves by 0.14-0.23 of its
bf16-vs-fp32 gap when the input moves by 1e-6, the port's is 0.13-0.22
from JAX's (four parameter seeds; 0.22 at this file's); at 0.1 the port
is 0.53 from it.
Every JAX call is jitted once, and the calls of each fixture are
compiled side by side.

Where XLA rounds (read from its optimized HLO): ``res + ftx`` of the
offsets is taken in fp32 by both of its consumers, the sampler and the
motion's coordinates (each casts it to fp32); each block's residual sum
before ``norm2`` is read by ``norm2`` unrounded and by the residual
rounded; the motion's per-group products are rounded before their mean,
which is summed in fp32; the self-attention divides by ``sqrt(C)`` as a
product with the fp32 reciprocal; ``jnp.linspace``'s division by
``n - 1`` is a product with the fp32 reciprocal.

Tolerances:
  * the coordinate grid: JAX's bit for bit, in fp32 and bf16;
  * fp32, the modules, the frame and the intermediates (``ft0``,
    ``ft1``): within 1e-3 max abs and 1e-5 mean abs of JAX;
  * bf16, the modules and the frame: mean abs at most half of JAX's own
    bf16-vs-fp32 gap;
  * the loss: each log term within 1e-5 relative; the whole gradient
    within 1e-4 relative in L2;
  * the flax round trip: exact;
  * the file: at most 40 s on one worker (``pytest
    tests/test_torch_madat.py -p no:xdist --durations=0``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from torch_tiny import compile_side_by_side, run_in, smooth_pair
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models.madat import MADAT as JaxMADAT
from videoframeinterpolation_tpu.models.madat import madat_loss as jax_madat_loss
from videoframeinterpolation_tpu.nn import madat as jax_madat
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.models import MADAT, create_model, multi_t_apply
from videoframeinterpolation_tpu_torch.nn import madat
from videoframeinterpolation_tpu_torch.nn.blocks import _fan_in
from videoframeinterpolation_tpu_torch.tools import fixtures
from videoframeinterpolation_tpu_torch.train import (create_train_state, make_loss_fn,
                                                     read_flax_msgpack, state_to_flax,
                                                     write_flax_state)
from videoframeinterpolation_tpu_torch.train import __main__ as train_cli
from videoframeinterpolation_tpu_torch.utils import logger as port_logger

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "archive" / "MADAT.yaml"
KW = dict(channels=(8, 16, 16), depths=(1, 1, 1), motion_dim=16, mlp_ratio=2.0)
NOISE = 0.05
B, H, W = 2, 64, 64
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The modules held alone: name -> the tiny model's submodule whose
# parameters they take (its flax path), and its input map (h, w, channels).
MODULES = {"dwconv_mlp": ("corr/mlp", (8, 8, 16)), "inter_frame_attention": ("corr", (8, 8, 16)),
           "flow_self_attn": ("self_attn2", (16, 16, 16)),
           "dat_g4": ("decoder2", (16, 16, 16)), "dat_g8": ("decoder1", (16, 16, 8))}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("h, w", [(8, 8), (8, 14), (7, 11), (32, 56), (64, 112), (128, 224),
                                  (1, 5)])
def test_normalized_coords_match_jax_bit_for_bit(h, w):
    """``(1, h*w, 2)`` as ``(x, y)``: JAX's grid as XLA computes it inside a
    jitted program, in fp32 and rounded to bf16; at 128 points or more
    ``torch.linspace`` differs from it."""
    for dtype in DTYPES:
        want = np.asarray(jax.jit(lambda: jax_madat._normalized_coords(h, w, DTYPES[dtype][0]))(),
                          np.float32)
        got = madat.normalized_coords(h, w, DTYPES[dtype][1])
        assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape == (1, h * w, 2)
        assert np.array_equal(got.float().numpy(), want), dtype
    if w >= 128:
        assert not np.array_equal(torch.linspace(-1, 1, w).numpy(), want[0, :w, 0])


# ---------------------------------------------------------------------------
# The tiny model, and its modules alone.

def _tiny_model() -> MADAT:
    """The port's initialisation (seed 0) plus noise of ``NOISE``."""
    torch.manual_seed(0)
    model = MADAT(**KW)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, NOISE, tuple(p.shape)).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny model's TrainState written by the port's checkpoint writer,
    JAX's parameters read from it, a seeded batch (a smooth pair, its mean
    as the ground truth, two instants) and the modules' seeded inputs."""
    model = _tiny_model()
    ckpt = tmp_path_factory.mktemp("madat") / "tiny.ckpt"
    write_flax_state(ckpt, state_to_flax(create_train_state(model, Config.from_yaml(YAML))))
    params = fser.msgpack_restore(ckpt.read_bytes())["params"]
    x0, x1 = smooth_pair(B, H, W, seed=12)
    batch = {"x0": x0, "x1": x1, "xt": 0.5 * (x0 + x1),
             "t": np.array([0.5, 0.3], np.float32).reshape(B, 1, 1, 1)}
    rng = np.random.default_rng(13)
    inputs = {}
    for name, (_, (h, w, c)) in MODULES.items():
        maps = [rng.normal(size=(B, h, w, c)).astype(np.float32) for _ in range(3)]
        flows = [rng.normal(0, 2.0, (B, h, w, 2)).astype(np.float32) for _ in range(2)]
        inputs[name] = {"dwconv_mlp": maps[:1], "inter_frame_attention": maps[:2],
                        "flow_self_attn": maps[:1] + flows}.get(name, maps + flows)
    return ckpt, params, batch, inputs


def _jax_module(name: str, dtype):
    """The JAX module of ``MODULES[name]`` at the tiny model's widths."""
    return {"dwconv_mlp": lambda: jax_madat.DWConvMlp(32, 16, dtype=dtype),
            "inter_frame_attention": lambda: jax_madat.InterFrameAttention(
                16, 16, mlp_ratio=2.0, dtype=dtype),
            "flow_self_attn": lambda: jax_madat.FlowSelfAttnPropagation(16, dtype=dtype),
            "dat_g4": lambda: jax_madat.DATWithMotionEstimation(
                16, 16, n_samples=9, n_groups=4, n_heads=4, mlp_ratio=2.0, motion_dim=16,
                dtype=dtype),
            "dat_g8": lambda: jax_madat.DATWithMotionEstimation(
                8, 8, n_samples=9, n_groups=8, n_heads=8, mlp_ratio=2.0, motion_dim=16,
                dtype=dtype)}[name]()


def _jax_modules(params, inputs, dtype):
    """Every module of ``MODULES`` on its inputs, in ``dtype``."""
    out = {}
    for name, (path, (h, w, c)) in MODULES.items():
        p = params["params"]
        for part in path.split("/"):
            p = p[part]
        args = [a.astype(dtype) for a in inputs[name]]
        if name == "dwconv_mlp":
            args = [args[0].reshape(B, h * w, c), h, w]
        out[name] = _jax_module(name, dtype).apply({"params": p}, *args)
    return out


@pytest.fixture(scope="module")
def jax_calls(tiny):
    """JAX's fp32 training loss (``train/step.py``'s MADAT branch) with its
    gradient, the log, the frame and the intermediates in its aux; its
    bf16 forward; and the modules in fp32 and bf16; compiled side by side."""
    _, params, batch, inputs = tiny
    model = JaxMADAT(**KW)

    def loss_fn(p, b):
        pred, inter = model.apply(p, b["x0"], b["x1"], b["t"], train=True)
        total, log = jax_madat_loss(pred, inter, b)
        return total, (log, pred, inter)

    x = [batch[k] for k in ("x0", "x1", "t")]
    return compile_side_by_side(
        (jax.value_and_grad(loss_fn, has_aux=True), (params, batch)),
        (JaxMADAT(**KW, dtype=jnp.bfloat16).apply, (params, *x)),
        *[(lambda p, i, d=d: _jax_modules(p, i, DTYPES[d][0]), (params, inputs)) for d in DTYPES])


@pytest.fixture(scope="module")
def jax_fp32(tiny, jax_calls):
    _, params, batch, _ = tiny
    (_, aux), grads = jax_calls[0](params, batch)
    return jax.tree_util.tree_map(np.asarray, aux), grads


@pytest.fixture(scope="module")
def jax_module_outputs(tiny, jax_calls):
    _, params, _, inputs = tiny
    return {d: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      jax_calls[2 + i](params, inputs))
            for i, d in enumerate(DTYPES)}


def _port(ckpt, dtype="float32") -> MADAT:
    """The tiny model with the checkpoint's parameters, in ``dtype``."""
    model = MADAT(**KW, compute_dtype=DTYPES[dtype][1])
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    return model.to(DTYPES[dtype][1]).eval()


def _port_module(model: MADAT, name: str, inputs: list, dtype: str):
    args = [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in inputs]
    module = model.get_submodule(MODULES[name][0].replace("/", "."))
    if name == "dwconv_mlp":
        h, w, c = MODULES[name][1]
        return module(args[0].reshape(B, h * w, c), h, w)
    return module(*args)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(MODULES))
def test_modules_match_jax(tiny, jax_module_outputs, name, dtype):
    """Each module on its seeded inputs, every output (the attended
    features and the motion; the propagated value and flows; the block's
    feature and both motions): fp32 within ``MAX_TOL`` max abs and
    ``MEAN_TOL`` mean abs of JAX; bf16 in the compute dtype, its mean abs
    at most half of JAX's own bf16-vs-fp32 gap."""
    ckpt, _, _, inputs = tiny
    with torch.no_grad():
        got = _port_module(_port(ckpt, dtype), name, inputs[name], dtype)
    got = got if isinstance(got, tuple) else (got,)
    want = jax_module_outputs[dtype][name]
    want = want if isinstance(want, tuple) else (want,)
    want32 = jax_module_outputs["float32"][name]
    want32 = want32 if isinstance(want32, tuple) else (want32,)
    assert len(got) == len(want) == {"inter_frame_attention": 2, "flow_self_attn": 3}.get(name, {
        "dwconv_mlp": 1}.get(name, 3))
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.dtype == DTYPES[dtype][1] and tuple(g.shape) == w.shape, (i, g.dtype, g.shape)
        err = np.abs(g.float().numpy() - w)
        if dtype == "float32":
            assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (i, err.max(), err.mean())
        else:
            gap = np.abs(w - w32).mean()
            assert gap > 0 and err.mean() <= BF16_GAP_SHARE * gap, (i, err.mean() / gap)


def test_dat_block_needs_as_many_groups_as_heads():
    """JAX asserts ``n_groups == n_heads``; the port raises."""
    with pytest.raises(ValueError, match="n_groups == n_heads"):
        madat.DATWithMotionEstimation(16, 16, n_groups=4, n_heads=8)


# MADAT's sampler launches: (B2, H, W, C, G, S) -> (the vector bytes of a
# bf16 and an fp32 call, the backward's plan (path, k, shared bytes)). A
# 448x256 request (B2 2), the recipe's training batch (12 pairs of 256x256,
# B2 24) and the fp32 step of two 128x128 pairs (B2 4); level 2 at 1/4 (8
# channels per group), level 1 at 1/2 (2 channels per group).
MADAT_LAUNCHES = {
    "request_lv2": ((2, 64, 112, 32, 4, 9), (16, 16), ("smem", 1, 28672)),
    "request_lv1": ((2, 128, 224, 16, 8, 9), (4, 8), ("smem", 1, 114688)),
    "recipe_lv2": ((24, 64, 64, 32, 4, 9), (16, 16), ("smem", 2, 32768)),
    "recipe_lv1": ((24, 128, 128, 16, 8, 9), (4, 8), ("smem", 1, 65536)),
    "step_lv2": ((4, 32, 32, 32, 4, 9), (16, 16), ("smem", 1, 4096)),
    "step_lv1": ((4, 64, 64, 16, 8, 9), (4, 8), ("smem", 1, 16384)),
}


@pytest.mark.parametrize("name", list(MADAT_LAUNCHES))
def test_sampler_width_and_backward_plan_at_madats_launches(name):
    """The widths and plans the wrapper picks at MADAT's level shapes: 2
    channels per group in bf16 are the 4-byte chunk; every backward sums
    ``grad_feat`` in shared memory, one wave of the card, the recipe's
    level 1 one channel per block (64 KiB), its level 2 two (32 KiB);
    32-bit indices throughout."""
    from videoframeinterpolation_tpu_torch.kernels.build import (
        BWD_FEAT_THREADS, SMEM_PER_SM, SMEM_RESERVED, SMS, THREADS_PER_SM)
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        _backward_plan, _index_bits, _vector_bytes)

    shape, widths, plan = MADAT_LAUNCHES[name]
    B2, h, w, C, G, S = shape
    assert tuple(_vector_bytes(C, G, e, 0, 0) for e in (2, 4)) == widths
    got = _backward_plan(*shape)
    assert (got.path, got.k, got.smem_bytes) == plan and got.index_bits == 32
    assert _index_bits(*shape) == 32
    per_sm = min(THREADS_PER_SM // ((BWD_FEAT_THREADS // got.k) * got.k),
                 SMEM_PER_SM // (got.smem_bytes + SMEM_RESERVED))
    assert B2 * (C // got.k) <= SMS * per_sm


# ---------------------------------------------------------------------------
# The whole model against JAX.

def test_forward_and_intermediates_match_jax_in_fp32(tiny, jax_fp32):
    """The frame and JAX's intermediates (``ft0``, ``ft1``: the flows from
    t at 1/1, 1/4 and 1/8); the two instants give different frames."""
    ckpt, _, batch, _ = tiny
    (_, ref_pred, ref_inter), _ = jax_fp32
    model = _port(ckpt)
    x = [torch.from_numpy(batch[k]) for k in ("x0", "x1", "t")]
    with torch.no_grad():
        pred, inter = model(*x, train=True)
        assert torch.equal(model(*x), pred)
    assert set(inter) == set(ref_inter) == {"ft0", "ft1"}
    pairs = [(pred, ref_pred)]
    for key in ("ft0", "ft1"):
        assert [tuple(f.shape) for f in inter[key]] == [f.shape for f in ref_inter[key]] == [
            (B, H, W, 2), (B, H // 4, W // 4, 2), (B, H // 8, W // 8, 2)]
        pairs += list(zip(inter[key], ref_inter[key]))
    for got, want in pairs:
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())
    # The flows move pixels.
    assert np.abs(ref_inter["ft0"][0]).max() > 1.0
    with torch.no_grad():
        other = model(x[0], x[1], torch.full_like(x[2], 0.8))
    assert not torch.equal(other, pred)


def test_forward_in_bf16_within_half_of_jaxs_own_gap(tiny, jax_calls, jax_fp32):
    ckpt, params, batch, _ = tiny
    (_, ref32, _), _ = jax_fp32
    x = [batch[k] for k in ("x0", "x1", "t")]
    ref16 = np.asarray(jax_calls[1](params, *x))
    model = _port(ckpt, "bfloat16")
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(*map(torch.from_numpy, x)).numpy()
    gap = np.abs(ref16 - ref32).mean()
    err = np.abs(out - ref16).mean()
    print(f"MADAT bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
    assert out.dtype == np.float32 and out.shape == ref16.shape == (B, H, W, 3)
    assert gap > 0 and err <= BF16_GAP_SHARE * gap


def test_loss_terms_and_gradients_match_jax(tiny, jax_fp32):
    """``madat_loss`` through ``make_loss_fn`` (Charbonnier and census on
    the frame) and every parameter's gradient."""
    ckpt, _, batch, _ = tiny
    (ref_log, _, _), ref_grads = jax_fp32
    cfg = Config.from_yaml(YAML, compute_dtype="float32")
    model = MADAT(**KW)
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    total, log = make_loss_fn(model, cfg)({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert set(log) == set(ref_log) == {"total_loss", "l1_loss", "census_loss"}
    for key, value in log.items():
        want = float(ref_log[key])
        assert want > 0 and abs(value.item() - want) <= LOSS_TOL * want, key
    ref = params_from_flax(ref_grads, model)
    assert all(p.grad is not None for p in model.parameters())
    got = torch.cat([p.grad.flatten() for _, p in sorted(model.named_parameters())])
    want = torch.cat([ref[k].flatten() for k, _ in sorted(model.named_parameters())])
    err = ((got - want).norm() / want.norm()).item()
    print(f"MADAT loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL
    # The offsets' predictor, zero-initialised in JAX, learns through the
    # sampler and the motion's coordinates.
    assert model.decoder1.conv_res_offset.weight.grad.abs().max() > 0


def test_flax_round_trip_is_exact(tiny):
    """Every leaf read and written back bit for bit, the top-level
    ``m2b*``/``m2f*`` heads, the depthwise kernels and the LayerNorms among
    them; a leaf of the wrong shape raises."""
    _, params, _, _ = tiny
    model = MADAT(**KW)
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)
    names = {jax.tree_util.keystr(k) for k in ref}
    for leaf in ("['m2b1']['conv']['kernel']", "['m2f3']['bias']",
                 "['corr']['mlp']['dwconv']['kernel']", "['decoder1']['norm2']['scale']",
                 "['decoder2']['res']['prelu2']['alpha']", "['rgb_builder']['in']['conv']['bias']",
                 "['encoder']['b2_down']['prelu']['alpha']", "['self_attn3']['k_proj']['kernel']"):
        assert f"['params']{leaf}" in names, leaf
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["params"]["m2f3"]["bias"] = bad["params"]["m2f3"]["bias"][:1]
    with pytest.raises(ValueError, match="m2f3"):
        params_from_flax(bad, model)


def test_full_width_model_from_the_yaml():
    """``configs/archive/MADAT.yaml`` (``model_name: MADATv1``) builds the
    port's MADAT in bf16 with JAX's parameter tree: the same names and
    shapes as ``jax.eval_shape`` of the JAX model's ``init``, 784,433
    parameters; ``MADAT`` names the same model."""
    cfg = Config.from_yaml(YAML)
    assert cfg.model_name == "MADATv1"
    model = create_model(cfg, torch.float32)
    assert isinstance(model, MADAT) and model.dtype == torch.bfloat16
    assert isinstance(create_model(Config.from_yaml(YAML, model_name="MADAT")), MADAT)
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmodel = jax_create_model(JaxConfig.from_yaml(YAML))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), x, x, np.zeros((1, 1, 1, 1)))
    ref = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    ours = params_to_flax(dict(model.named_parameters()), model)
    assert ref == {jax.tree_util.keystr(k): v.shape
                   for k, v in jax.tree_util.tree_leaves_with_path(ours)}
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in ref.values()) == 784_433


def test_init_follows_the_jax_rules():
    """At full width each kernel is drawn by its flax layer's rule: the
    self-attentions' xavier-uniform, flax's default ``lecun_normal`` for
    the other Dense layers and the depthwise convs (truncated at two
    standard deviations), zeros for ``conv_res_offset`` and the biases,
    PReLU at 0.25, LayerNorm scales at 1, and ``U(+-fan_in^-1/2)`` for
    every other conv: each within its bound, and each of 1,000 or more
    values with a std within 20% of its rule's."""
    torch.manual_seed(0)
    model = create_model(Config.from_yaml(YAML), torch.float32)
    modules = dict(model.named_modules())
    seen = set()
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf == "alpha":
            assert torch.all(p == 0.25), name
            continue
        if leaf == "scale":
            assert torch.all(p == 1.0), name
            continue
        if leaf == "bias" or owner.endswith("conv_res_offset"):
            assert not p.any(), name
            continue
        fan_in = _fan_in(modules[owner])
        if ".self_attn" in f".{owner}":
            fan_out = p.shape[0]
            bound = (6 / (fan_in + fan_out)) ** 0.5
            std, rule = bound / 3 ** 0.5, "xavier"
        elif isinstance(modules[owner], torch.nn.Linear) or owner.endswith("dwconv"):
            std = fan_in ** -0.5
            bound, rule = 2 * std / 0.87962566103423978, "lecun"
        else:
            bound = fan_in ** -0.5
            std, rule = bound / 3 ** 0.5, "torch"
        seen.add(rule)
        assert p.abs().max() <= bound, name
        if p.numel() >= 1000:
            assert 0.8 <= p.std().item() / std <= 1.25, (name, p.std().item(), std)
    assert seen == {"xavier", "lecun", "torch"}


# ---------------------------------------------------------------------------
# The entry points on configs/archive/MADAT.yaml (its widths narrowed).

TINY_SETS = ["channels=[8, 16, 16]", "depths=[1, 1, 1]", "mlp_ratio=2.0", "crop_h=32",
             "crop_w=32", "batch_size=2", "num_workers=1", "num_epochs=1",
             "compute_dtype=float32", "metric_summary_freq=1", "img_summary_freq=2"]


@pytest.fixture(scope="module")
def madat_run(tmp_path_factory):
    """Two steps of ``python -m videoframeinterpolation_tpu_torch.train`` on
    the YAML at narrow widths and 32x32 crops, validated after its epoch.
    The YAML's ``data_name: Vimeo90K`` carries no flows, and MADAT's loss
    needs none."""
    base = tmp_path_factory.mktemp("madat_run")
    fixtures.write_vimeo90k_train(base, 4, (40, 48), [(32, 48)] * 2, seed=17)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        torch.set_num_threads(1)
        trainer = run_in(base, train_cli.main, ["--exp_name", "mad", "--config", str(YAML),
                                                "--device", "cpu",
                                                *[a for kv in TINY_SETS for a in ("--set", kv)]])
    return base, trainer


def test_train_cli_trains_the_yaml(madat_run):
    base, trainer = madat_run
    assert isinstance(trainer.state.model, MADAT) and trainer.state.step == 2
    assert trainer.state.model.encoder.b0_down.conv.weight.shape[0] == 8
    run = base / "exps" / "mad"
    cfg = Config.from_yaml(run / "config.yaml")
    assert (cfg.model_name, cfg.data_name, list(cfg.channels)) == ("MADATv1", "Vimeo90K",
                                                                  [8, 16, 16])
    records = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
               if "train/total_loss" in r]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[f"train/{k}"]) and r[f"train/{k}"] > 0 for r in records
               for k in ("l1_loss", "census_loss"))
    assert (run / "checkpoints" / "best_vimeo90k.ckpt").is_file()
    # No flows in the batch: the prediction strip alone.
    assert sorted(p.name for p in (run / "images").iterdir()) == ["pred_0000002.png"]


def test_evaluate_and_interpolate_serve_the_run(madat_run, tmp_path):
    """``evaluate --exp_name`` gives the trainer's validation score;
    ``interpolate`` serves the run's checkpoint in pair and in recursive
    sequence mode, and refuses ``--tile`` and ``--mode direct``."""
    base, _ = madat_run
    scores = run_in(base, evaluate.main, ["--exp_name", "mad", "--device", "cpu"])
    val = [r for r in map(json.loads, (base / "exps" / "mad" / "metrics.jsonl").read_text()
                          .splitlines()) if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert abs(scores["val/vimeo90k_psnr"] - val[0]["val/vimeo90k/val/vimeo90k_psnr"]) <= 1e-4
    config = str(base / "exps" / "mad" / "config.yaml")
    ckpt = str(base / "exps" / "mad" / "checkpoints" / "best_vimeo90k.ckpt")
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    pair = ["--frame0", str(seq / "im1.png"), "--frame1", str(seq / "im3.png")]
    interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                      str(tmp_path / "mid.png"), "--t", "0.25", "--device", "cpu"])
    model = interpolate.load_model(Config.from_yaml(config), ckpt, device="cpu")
    frames = [interpolate.read_frame(seq / f) for f in ("im1.png", "im2.png", "im3.png")]
    assert np.array_equal(interpolate.read_frame(tmp_path / "mid.png"),
                          interpolate.interp_pair(model, frames[0], frames[2], t=0.25))

    (tmp_path / "in").mkdir()
    for i, f in enumerate(frames):
        interpolate.write_frame(tmp_path / "in" / f"{i}.png", f)
    interpolate.main(["--config", config, "--ckpt", ckpt, "--in_dir", str(tmp_path / "in"),
                      "--out_dir", str(tmp_path / "out"), "--factor", "2", "--device", "cpu"])
    written = sorted((tmp_path / "out").iterdir())
    assert [p.name for p in written] == [f"{i:06d}.png" for i in range(5)]
    assert np.array_equal(interpolate.read_frame(written[1]),
                          interpolate.interp_pair(model, frames[0], frames[1]))

    with pytest.raises(SystemExit, match="MADAT returns none"):
        interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                          str(tmp_path / "t.png"), "--tile", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="MADAT returns none"):
        run_in(base, evaluate.main, ["--exp_name", "mad", "--tile", "16", "--device", "cpu"])
    with pytest.raises(ValueError, match="no staged encode/decode"):
        interpolate.upsample_sequence(model, frames, 4, mode="direct")
    with pytest.raises(ValueError, match="no staged encode/decode"):
        multi_t_apply(model, *(torch.zeros(1, 32, 32, 3),) * 2, [0.5])
