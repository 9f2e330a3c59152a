"""DCNTrans v1 in the port against the JAX package (CPU, narrow widths), and its entry points on ``configs/archive/DCNTrans.yaml``.

A tiny DCNTrans (nf 16, one encoder and one decoder residual block; the
two Swin decoders keep their fixed depth of 8) on 48x40 frames (two
pairs), so that level 2 (12x10) pads to whole windows and shifts. Its
parameters are the port's initialisation plus seeded noise of scale 0.02,
written by the port's checkpoint writer and read by JAX (no flax ``init``
runs). Every JAX call on the model is jitted once and shared: one fp32
``value_and_grad`` of the training loss, whose aux carries the frame and
the intermediates, and one bf16 forward, the two compiled side by side.

Tolerances:
  * the sine position embedding: its arguments bit for bit; the sines and
    cosines within one fp32 ulp (XLA's CPU ``sin``/``cos`` are
    approximations of their own; the port rounds float64 values once);
  * flax's LayerNorm and one Swin block (padded, shrunken and shifted
    windows): fp32 within 2e-6 max abs, bf16 bit for bit. The bf16 block
    is exact only where the port leaves two sums unrounded as XLA does
    (the scaled queries, ``mlp2``'s bias add); rounding either flips 15%
    of the block's outputs;
  * fp32, the frame and every intermediate (``feat_t_3``, ``feat_t_2``,
    ``f01_off``, ``f10_off``, ``mean``): 1e-3 max abs and 1e-5 mean abs;
  * bf16: mean abs at most half of JAX's own bf16-vs-fp32 gap
    (``BF16_GAP_SHARE``). Up to three blocks deep a decoder is bit-exact;
    past that, rare rounding flips (the two frameworks' fp32 softmax sums
    and ``exp`` differ in the last bit) grow through the 16 blocks. At a
    noise scale of 0.05 the tiny model is chaotic in bf16: JAX's own frame
    moves by 0.87-0.92 of its gap when the input moves by 1e-6 (0.32-0.33
    at 0.02, where the port's frame is 0.13-0.30 of the gap from JAX's;
    two parameter seeds);
  * the loss: each log term within 1e-5 relative, the whole gradient
    within 1e-4 relative in L2 (as DCNDAT in ``test_torch_dcndat.py``);
  * the flax round trip: exact.
"""

import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from torch_tiny import compile_side_by_side, run_in, smooth_pair, write_tiny_checkpoint
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models.dcntrans import DCNTrans as JaxDCNTrans
from videoframeinterpolation_tpu.models.dcntrans import dcntrans_loss as jax_dcntrans_loss
from videoframeinterpolation_tpu.nn import position as jax_position
from videoframeinterpolation_tpu.nn.swin import SwinDecoder as JaxSwinDecoder
from videoframeinterpolation_tpu.nn.swin import SwinIRBlock as JaxSwinIRBlock
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.models import DCNTrans, create_model, multi_t_apply
from videoframeinterpolation_tpu_torch.nn import position, swin
from videoframeinterpolation_tpu_torch.nn.blocks import LayerNorm, _fan_in
from videoframeinterpolation_tpu_torch.nn.position import position_embedding_sine
from videoframeinterpolation_tpu_torch.nn.swin import SwinDecoder, SwinIRBlock
from videoframeinterpolation_tpu_torch.tools import fixtures
from videoframeinterpolation_tpu_torch.train import make_loss_fn, read_flax_msgpack
from videoframeinterpolation_tpu_torch.train import __main__ as train_cli
from videoframeinterpolation_tpu_torch.train.trainer import build_dataset
from videoframeinterpolation_tpu_torch.utils import logger as port_logger

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "archive" / "DCNTrans.yaml"
KW = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1)
TINY = Config.from_yaml(YAML, compute_dtype="float32", **KW)
NOISE = 0.02
B, H, W = 2, 48, 40
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BLOCK_TOL = 2e-6
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _same_input(a: np.ndarray, dtype: str):
    """``a`` rounded to ``dtype``, as a JAX array and as a torch tensor."""
    jdt, tdt = DTYPES[dtype]
    ja = jnp.asarray(a, jdt)
    return ja, torch.tensor(np.asarray(ja, np.float32)).to(tdt)


# ---------------------------------------------------------------------------
# The new modules: the position embedding, LayerNorm, one Swin block.

@pytest.mark.parametrize("h, w, n", [(12, 10, 8), (64, 112, 32)])
def test_position_embedding_sine_matches_jax(h, w, n):
    """``(1, h, w, 2n)``, y-features first (the tiny model's level 2, and
    the full-width model's at 448x256): the sines' and cosines' arguments
    are JAX's bit for bit (fp32 cumsum, normalisation, the ``10000 ** (2
    floor(i/2) / n)`` divisor); the values within one fp32 ulp of XLA's CPU
    ``sin``/``cos``; the bf16 embedding is the fp32 one rounded once."""

    def jax_reads():
        jy = jnp.cumsum(jnp.ones((h, w), jnp.float32), axis=0)
        jy = jy / (jy[-1:] + 1e-6) * (2 * np.pi)
        jdim = 10000.0 ** (2 * jnp.floor(jnp.arange(n, dtype=jnp.float32) / 2) / n)
        return jax_position.position_embedding_sine(h, w, n), jy[:, :, None] / jdim

    ref, ref_args = (np.asarray(a) for a in jax.jit(jax_reads)())
    got = position_embedding_sine(h, w, n)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (1, h, w, 2 * n)
    assert np.all(np.abs(got.numpy() - ref) <= np.spacing(np.abs(ref)))
    # The arguments, with the port's fp32 operations.
    y = torch.cumsum(torch.ones(h, w), 0)
    y = y / (y[-1:] + 1e-6) * (2 * np.pi)
    dim_t = 10000.0 ** (2 * torch.floor(torch.arange(n, dtype=torch.float32) / 2) / n)
    assert np.array_equal((y[:, :, None] / dim_t).numpy(), ref_args)
    bf = position_embedding_sine(h, w, n, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))
    assert position_embedding_sine(h, w, n) is got          # one constant per shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    """flax's ``nn.LayerNorm``: epsilon 1e-6, fp32 statistics from any
    input, the fast variance, one rounding at the end; ``scale`` and
    ``bias`` stay fp32 in a bf16 model. Rows of std 1 and of std 0.03
    (where epsilon 1e-5 moves the output by 3e-2), each with a mean of
    half its std: fp32 within ``BLOCK_TOL``, bf16 bit for bit (statistics
    taken in bf16 move 50% of the values)."""
    rng = np.random.default_rng(3)
    sd = rng.choice([1.0, 0.03], (6, 40, 1))
    x = sd * (rng.normal(0, 1, (6, 40, 16)) + rng.normal(0, 0.5, (6, 40, 1)))
    scale = (1 + rng.normal(0, 0.1, 16)).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    ja, tx = _same_input(x, dtype)
    ref = np.asarray(jax.jit(fnn.LayerNorm(dtype=DTYPES[dtype][0]).apply)(
        {"params": {"scale": scale, "bias": bias}}, ja), np.float32)
    ln = LayerNorm(16)
    ln.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    ln = ln.to(DTYPES[dtype][1])
    assert ln.scale.dtype == ln.bias.dtype == torch.float32
    with torch.no_grad():
        got = ln(tx)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        assert np.abs(got.numpy() - ref).max() <= BLOCK_TOL
    else:
        assert np.array_equal(got.float().numpy(), ref)


BLOCK_CASES = {"padded": (12, 10, 0), "padded_shifted": (12, 10, 2), "shrunken": (3, 5, 2),
               "shrunken_2x2": (2, 2, 0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_swin_block_matches_jax(case, dtype):
    """One ``SwinIRBlock`` (16 channels, 8 heads, window 4, mlp ratio 2) at
    sizes that pad to whole windows, shift, or shrink the window below 4
    (where the shift goes unused and the bias table is sized by the
    input), the query attending onto a second map; parameters drawn by the
    port (plus noise) and read by flax. fp32 within ``BLOCK_TOL``, bf16 bit
    for bit."""
    h, w, shift = BLOCK_CASES[case]
    torch.manual_seed(1)
    block = SwinIRBlock(16, 8, 4, shift, 2.0, smallest_side=min(h, w))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape)).astype(np.float32)))
    params = params_to_flax(dict(block.named_parameters()), block)
    window = min(4, h, w)
    assert params["params"]["attn"]["relative_position_bias_table"].shape == (
        (2 * window - 1) ** 2, 8)
    (jx, tx), (jf, tf) = (_same_input(rng.normal(size=(2, h, w, 16)), dtype) for _ in range(2))
    jblock = JaxSwinIRBlock(16, 8, 4, shift_size=shift, mlp_ratio=2.0, dtype=DTYPES[dtype][0])
    ref = np.asarray(jax.jit(jblock.apply)(params, jx, jf), np.float32)
    with torch.no_grad():
        got = block.to(DTYPES[dtype][1])(tx, tf)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (2, h, w, 16)
    if dtype == "float32":
        assert np.abs(got.numpy() - ref).max() <= BLOCK_TOL
    else:
        assert np.array_equal(got.float().numpy(), ref)
    if window < 4:
        with pytest.raises(ValueError, match="relative position table"):
            block(torch.zeros(1, 4, 4, 16, dtype=got.dtype), torch.zeros(1, 4, 4, 16,
                                                                        dtype=got.dtype))


def test_swin_decoder_with_its_upsample_head_matches_jax():
    """``SwinDecoder`` with ``upsample_to`` (GMTrans's and RSTT's head, flax
    name ``upconv``): two blocks, the second shifted, both frames, their
    mixers and the ConvTranspose 2x head, in fp32."""
    torch.manual_seed(2)
    decoder = SwinDecoder(16, 2, 4, 4, 2.0, upsample_to=8)
    params = params_to_flax(dict(decoder.named_parameters()), decoder)
    assert set(params["params"]) == {"transformer", "upconv"}
    rng = np.random.default_rng(5)
    x, src, tgt = (rng.normal(size=(1, 8, 12, 16)).astype(np.float32) for _ in range(3))
    ref = jax.jit(JaxSwinDecoder(16, 2, 4, 4, 2.0, upsample_to=8).apply)(params, x, src, tgt)
    with torch.no_grad():
        got = decoder(*map(torch.from_numpy, (x, src, tgt)))
    assert tuple(got.shape) == ref.shape == (1, 16, 24, 8)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= BLOCK_TOL


# ---------------------------------------------------------------------------
# The whole model against JAX.

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The checkpoint (written by the port), JAX's parameters read from it,
    and a seeded batch: a smooth pair, its mean as the ground truth, and
    pseudo-GT flows."""
    ckpt = write_tiny_checkpoint(tmp_path_factory.mktemp("dcntrans") / "tiny.ckpt", seed=0,
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
    """JAX's two calls on the tiny model, traced one after the other and
    compiled side by side (XLA compiles outside the interpreter lock): the
    fp32 training loss (``train/step.py``'s DCNTrans branch) with its
    gradient, the log, the frame and the intermediates in its aux; and the
    bf16 forward."""
    _, params, batch = tiny
    model = JaxDCNTrans(**KW)

    def loss_fn(p, b):
        pred, inter = model.apply(p, b["x0"], b["x1"], b["t"], train=True)
        total, log = jax_dcntrans_loss(model, p, pred, inter, b)
        return total, (log, pred, inter)

    x = [batch[k] for k in ("x0", "x1", "t")]
    return compile_side_by_side((jax.value_and_grad(loss_fn, has_aux=True), (params, batch)),
                                (JaxDCNTrans(**KW, dtype=jnp.bfloat16).apply, (params, *x)))


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
        # v1 does not read t.
        assert torch.equal(model(x[0], x[1], torch.full_like(x[2], 0.125)), pred)
    assert set(inter) == set(ref_inter) == {"feat_t_3", "feat_t_2", "f01_off", "f10_off", "mean"}
    shapes = {"feat_t_3": (B, H // 8, W // 8, 16), "feat_t_2": (B, H // 4, W // 4, 16),
              "f01_off": (B, H // 8, W // 8, 2), "f10_off": (B, H // 8, W // 8, 2),
              "mean": (B, 1, 1, 3)}
    for key, shape in shapes.items():
        assert tuple(inter[key].shape) == ref_inter[key].shape == shape, key
    assert inter["f01_off"].dtype == torch.float32
    for got, want in [(pred, ref_pred)] + [(inter[k], ref_inter[k]) for k in shapes]:
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())
    # The offset flows are not at their zero init.
    assert min(np.abs(ref_inter[k]).max() for k in ("f01_off", "f10_off")) > 0.01


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
    print(f"DCNTrans bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
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
    print(f"DCNTrans loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL


def test_constants_made_while_serving_serve_training(tiny):
    """The window index, the shift mask and the position embedding are
    made once per shape; made first under ``torch.inference_mode`` (as
    ``interp_pair`` serves), they still serve a training step."""
    ckpt, _, batch = tiny
    swin._on_device.cache_clear()
    position._embedding.cache_clear()
    model = create_model(TINY, torch.float32)
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    with torch.inference_mode():
        model(*[torch.from_numpy(batch[k]) for k in ("x0", "x1", "t")])
    assert swin._on_device.cache_info().currsize == 3          # the index and two masks
    total, _ = make_loss_fn(model, TINY)(_torch(batch))
    total.backward()
    assert all(p.grad is not None for p in model.parameters())


def test_flax_round_trip_is_exact(tiny):
    """Every leaf, the new ones included (LayerNorm ``scale``/``bias``,
    ``relative_position_bias_table``, the bias-free ``merge`` kernel,
    ``decoder{1,2}/transformer/block{i}``, ``mixer{i}``,
    ``mixer{i}_prelu``), read and written back bit for bit; a leaf of the
    wrong shape raises."""
    _, params, _ = tiny
    model = DCNTrans(**KW)
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)
    names = {jax.tree_util.keystr(k) for k in ref}
    for leaf in ("['decoder2']['transformer']['block7']['norm2']['scale']",
                 "['decoder1']['transformer']['block0']['attn']['relative_position_bias_table']",
                 "['decoder1']['transformer']['block3']['merge']['kernel']",
                 "['decoder2']['transformer']['mixer5_prelu']['alpha']",
                 "['dcn_builder']['dcn1t']['weight']"):
        assert f"['params']{leaf}" in names, leaf
    bad = jax.tree_util.tree_map(np.asarray, params)
    table = bad["params"]["decoder2"]["transformer"]["block0"]["attn"]
    table["relative_position_bias_table"] = table["relative_position_bias_table"][:-1]
    with pytest.raises(ValueError, match="relative_position_bias_table"):
        params_from_flax(bad, model)


def test_full_width_model_from_the_yaml():
    """``configs/archive/DCNTrans.yaml`` (``model_name: DCNTransv1``) builds
    the port's DCNTrans in bf16 with JAX's parameter tree: the same names
    and shapes as ``jax.eval_shape`` of the JAX model's ``init``, 4,107,351
    parameters; the bias tables and LayerNorms stay fp32 in the bf16
    model. ``DCNTrans`` names the same model; ``DCNTransv2`` and
    ``DCNTransFwarp`` (the forward warp, not ported) raise."""
    cfg = Config.from_yaml(YAML)
    assert cfg.model_name == "DCNTransv1"
    model = create_model(cfg, torch.float32)
    assert isinstance(model, DCNTrans) and model.dtype == torch.bfloat16
    assert isinstance(create_model(Config.from_yaml(YAML, model_name="DCNTrans")), DCNTrans)
    for name in ("DCNTransv2", "DCNTransFwarp"):
        with pytest.raises(ValueError, match="queue 1 item 9c"):
            create_model(Config.from_yaml(YAML, model_name=name))
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmodel = jax_create_model(JaxConfig.from_yaml(YAML))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), x, x, np.zeros((1, 1, 1, 1)))
    ref = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    ours = params_to_flax(dict(model.named_parameters()), model)
    assert ref == {jax.tree_util.keystr(k): v.shape
                   for k, v in jax.tree_util.tree_leaves_with_path(ours)}
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in ref.values()) == 4_107_351
    served = create_model(cfg)
    kept = {n for n, p in served.named_parameters() if p.dtype == torch.float32}
    assert kept == {n for n in kept if n.endswith(("relative_position_bias_table", ".scale"))
                    or ".norm" in n} and len(kept) == 16 * 5
    assert all(p.dtype == torch.bfloat16 for n, p in served.named_parameters() if n not in kept)


def test_init_follows_the_jax_rules():
    """At full width, each parameter drawn by its JAX counterpart's rule
    (``nn/blocks.py:23-26``, ``nn/swin.py:27``, flax's ``LayerNorm``):
    zero biases and offset-and-mask predictors, PReLU at 0.25, LayerNorm
    scales at one, the Swin layers' kernels and bias tables
    ``truncated_normal(0.02)`` (within 0.04, std 0.0176), the grouped DCN
    weights ``U(+-(Cin/G * 9)^-1/2)``, the residual blocks' kernels
    ``N(0, 0.02 / fan_in)`` and every other kernel ``U(+-fan_in^-1/2)``:
    each kernel of 1,000 or more values within its bound and with a std
    within 20% of its rule's."""
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
        if leaf == "bias" or owner.endswith("om_out"):
            assert not p.any(), name
            continue
        if owner.endswith(("dcn0t", "dcn1t")):
            G, KK, Cg, _ = p.shape
            bound, std = (Cg * KK) ** -0.5, (Cg * KK) ** -0.5 / 3 ** 0.5
            rule = "dcn"
        elif leaf == "relative_position_bias_table" or ".transformer.block" in owner:
            bound, std, rule = 0.04, 0.02 * 0.87962566103423978, "trunc02"
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
    assert seen == {"dcn", "trunc02", "res", "torch"}


# ---------------------------------------------------------------------------
# The entry points on configs/archive/DCNTrans.yaml.

TINY_SETS = ["data_name=Vimeo90KwFlow", "nf=16", "enc_res_blocks=1", "dec_res_blocks=1",
             "crop_h=32", "crop_w=32", "batch_size=2", "num_workers=1", "num_epochs=1",
             "compute_dtype=float32", "metric_summary_freq=1", "img_summary_freq=2"]


@pytest.fixture(scope="module")
def dcntrans_run(tmp_path_factory):
    """Two steps of ``python -m videoframeinterpolation_tpu_torch.train`` on
    the YAML at tiny widths, validated after its epoch. The YAML names
    ``data_name: Vimeo90K``, whose batches carry no flows for the offset
    flows' distillation: the run sets ``Vimeo90KwFlow``, which reads the
    YAML's ``flow_dir`` and ``distill_bwd``."""
    base = tmp_path_factory.mktemp("dcntrans_run")
    fixtures.write_vimeo90k_train(base, 4, (40, 48), [(32, 48)] * 2, seed=17)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        torch.set_num_threads(1)
        trainer = run_in(base, train_cli.main, ["--exp_name", "dct", "--config", str(YAML),
                                                "--device", "cpu",
                                                *[a for kv in TINY_SETS for a in ("--set", kv)]])
    return base, trainer


def test_train_cli_trains_the_yaml(dcntrans_run):
    base, trainer = dcntrans_run
    # The YAML's own Vimeo90K gives batches without flows: the loss says so.
    cfg = Config.from_yaml(YAML, root=str(base / "datasets" / "vimeo_triplet"), crop_h=32,
                           crop_w=32, compute_dtype="float32", **KW)
    item = {k: torch.from_numpy(v)[None] for k, v in build_dataset(cfg)[0].items()}
    assert "f0x" not in item
    with pytest.raises(ValueError, match="data_name Vimeo90KwFlow"):
        make_loss_fn(create_model(cfg), cfg)(item)
    assert isinstance(trainer.state.model, DCNTrans) and trainer.state.step == 2
    run = base / "exps" / "dct"
    cfg = Config.from_yaml(run / "config.yaml")
    assert (cfg.model_name, cfg.data_name, cfg.flow_dir, cfg.distill_bwd) == (
        "DCNTransv1", "Vimeo90KwFlow", "flow", True)
    records = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
               if "train/total_loss" in r]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[f"train/{k}"]) and r[f"train/{k}"] > 0 for r in records
               for k in ("l1_loss", "census_loss", "geometry_loss", "flow_loss"))
    assert (run / "checkpoints" / "best_vimeo90k.ckpt").is_file()
    assert sorted(p.name for p in (run / "images").iterdir()) == ["flow_0000002.png",
                                                                  "pred_0000002.png"]


def test_evaluate_and_interpolate_serve_the_run(dcntrans_run, tmp_path):
    """``evaluate --exp_name`` gives the trainer's validation score;
    ``interpolate`` serves the run's checkpoint in pair and in recursive
    sequence mode (every instant the same frame: v1 does not read t), and
    refuses ``--tile`` and ``--mode direct``."""
    base, _ = dcntrans_run
    scores = run_in(base, evaluate.main, ["--exp_name", "dct", "--device", "cpu"])
    val = [r for r in map(json.loads, (base / "exps" / "dct" / "metrics.jsonl").read_text()
                          .splitlines()) if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert abs(scores["val/vimeo90k_psnr"] - val[0]["val/vimeo90k/val/vimeo90k_psnr"]) <= 1e-4
    config = str(base / "exps" / "dct" / "config.yaml")
    ckpt = str(base / "exps" / "dct" / "checkpoints" / "best_vimeo90k.ckpt")
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    pair = ["--frame0", str(seq / "im1.png"), "--frame1", str(seq / "im3.png")]
    interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                      str(tmp_path / "mid.png"), "--t", "0.25", "--device", "cpu"])
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

    with pytest.raises(SystemExit, match="DCNTrans returns none"):
        interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                          str(tmp_path / "t.png"), "--tile", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="DCNTrans returns none"):
        run_in(base, evaluate.main, ["--exp_name", "dct", "--tile", "16", "--device", "cpu"])
    with pytest.raises(ValueError, match="no staged encode/decode"):
        interpolate.upsample_sequence(model, frames, 4, mode="direct")
    with pytest.raises(ValueError, match="no staged encode/decode"):
        multi_t_apply(model, *(torch.zeros(1, 32, 32, 3),) * 2, [0.5])
