"""The flagship's variants in the port against the JAX package (CPU, narrow widths).

The strided sampler's plain version (JAX ``_grouped_deformable_sample(...,
stride=2)``), the cross-attention block with each option (``attn_stride``
2, ``movement_nf``, ``ref_offset_units``, ``window_sampling`` against JAX's
windowed path), JAX's refusals, the quality study's two arms as whole
models (the stride arm: shared offsets, samples 8/8/16, lv1 at stride 2;
the movement arm: samples 8/8/2, movement widths 16/16/8 at nf 16), the
flax round trip, the initialisation and the full-width parameter counts;
then the entry points: the quality-study trainer with its seven options,
``--window_sampling`` in ``evaluate`` and ``interpolate``, and the four
fields through a YAML.

Blocks are 16 channels on 8x12 maps; whole models nf 16 with one encoder
and one decoder block on 32x48 frames (two pairs). Parameters are a flax
initialisation plus seeded noise (so ``conv_res_offset`` and
``conv_detail``, zero at init, act), carried to the port by
``interop.params_from_flax``.

Tolerances:
  * the strided sampler: 1e-5 absolute, forward and VJP (the same
    arithmetic step for step);
  * a block in fp32: 1e-5 absolute; its gradient (of a seeded weighting of
    the outputs, for every parameter and input) 1e-4 relative in L2; in
    bf16, mean abs at most half of JAX's own bf16-vs-fp32 gap
    (``BF16_GAP_SHARE``; JAX's windowed path also rounds each tent weight
    and partial sum in bf16, ``ops/windowed.py:164-169``);
  * a whole model in fp32 (``train=False`` and the frame and flows of
    ``train=True``): 1e-3 max abs and 1e-5 mean abs; in bf16 on a smooth
    pair, half of JAX's own gap;
  * ``dat_loss``: each log term within 1e-5 relative, the whole gradient
    within 1e-4 relative in L2;
  * the flax round trip: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_tiny import (TINY, jax_init, perturbed, run_in, smooth_pair,
                        write_tiny_checkpoint)
from videoframeinterpolation_tpu import nn as jnn
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models.dat import DATwConstantnC as JaxDAT
from videoframeinterpolation_tpu.nn.deformable_attn import (
    _grouped_deformable_sample as jax_grouped_sample)
from videoframeinterpolation_tpu.train.step import make_loss_fn as jax_make_loss_fn
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch import nn as pnn
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.kernels.window_sample import (
    _backward_plan, _check, _grouped_deformable_sample, _index_bits, deformable_sample)
from videoframeinterpolation_tpu_torch.models import DATwConstantnC, create_model
from videoframeinterpolation_tpu_torch.nn.blocks import avg_pool
from videoframeinterpolation_tpu_torch.tools import fixtures, head_to_head
from videoframeinterpolation_tpu_torch.train import make_loss_fn, read_flax_state

OP_TOL = 1e-5
BLOCK_GRAD_TOL = 1e-4
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, H, W = 2, 32, 48
ARMS = {"stride": dict(shared_offsets=True, n_samples=(8, 8, 16), attn_strides=(1, 1, 2)),
        "movement": dict(shared_offsets=True, n_samples=(8, 8, 2), movement_nf=(16, 16, 8))}
KW = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)
            for a in arrays]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- the sampler


def test_strided_sampler_matches_jax_forward_and_vjp():
    """The plain strided sampler against JAX's, with offsets large enough
    to put taps past every border, and its VJP for the features and the
    offsets; the wrapper on the CPU (flow and residual apart) too."""
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, 8, 12, 6)).astype(np.float32)
    off = rng.normal(0, 5.0, (2, 4, 6, 2, 3, 2)).astype(np.float32)
    flow = rng.normal(0, 2.0, (2, 4, 6, 2)).astype(np.float32)
    cot = rng.normal(size=(2, 3, 24, 6)).astype(np.float32)
    def fwd_vjp(f, o, c):
        out, vjp = jax.vjp(lambda f, o: jax_grouped_sample(f, o, 2, stride=2), f, o)
        return (out, *vjp(c))

    ref, ref_feat, ref_off = jax.jit(fwd_vjp)(feat, off, cot)
    pf, po = (x.requires_grad_() for x in _t(feat, off))
    out = _grouped_deformable_sample(pf, po, 2, stride=2)
    out.backward(*_t(cot))
    coords = np.arange(6) * 2 + 0.5 + off[..., 0].transpose(0, 3, 4, 1, 2)
    assert (coords < 0).any() and (coords > 11).any()
    assert out.shape == (2, 3, 24, 6)
    for got, want in ((out, ref), (pf.grad, ref_feat), (po.grad, ref_off)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=OP_TOL)
    res = off - flow[:, :, :, None, None, :]
    wrapped = deformable_sample(*_t(feat, flow, res), 2, stride=2)
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(ref), rtol=0, atol=OP_TOL)


def test_the_wrapper_checks_the_query_grid_and_counts_the_features():
    """The query grid is read from the flow and residual at ``stride``;
    index widths count the full-resolution features; the backward's plan
    holds the feature grid's gradient whatever the stride."""
    feat, flow, res = _t(np.zeros((2, 8, 12, 4)), np.zeros((2, 4, 6, 2)),
                         np.zeros((2, 4, 6, 1, 3, 2)))
    _check(feat, flow, res, 1, 2)
    for bad in ((feat, flow, res, 1, 1), (feat, flow, res, 1, 3),
                (feat[:, :7], flow, res, 1, 2)):
        with pytest.raises(ValueError):
            _check(*bad)
    # 2^31 features on a stride-2 grid whose output alone would fit 32 bits.
    assert _index_bits(1, 2 ** 14, 2 ** 14, 8, 1, 1, 2) == 64
    assert _index_bits(1, 2 ** 14, 2 ** 14, 4, 1, 1, 2) == 32
    assert _index_bits(2, 128, 224, 72, 1, 16, 2) == _index_bits(2, 128, 224, 72, 1, 16) == 32
    assert (_backward_plan(16, 64, 64, 72, 1, 16, 2)[:3]
            == _backward_plan(16, 64, 64, 72, 1, 16)[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_pool_rounds_as_flax_does(dtype):
    import flax.linen as fnn

    x = np.random.default_rng(1).normal(0, 3, (2, 8, 12, 16)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax.jit(lambda a: fnn.avg_pool(a, (2, 2), strides=(2, 2)))(jnp.asarray(x, jdt))
    out = avg_pool(*_t(x, dtype=dtype), 2)
    assert np.array_equal(out.float().numpy(), np.asarray(ref, np.float32))


# ---------------------------------------------------------------- the block

BLOCK_OPTIONS = {"attn_stride": dict(attn_stride=2, pred_res_flow=False),
                 "movement_nf": dict(movement_nf=8),
                 "ref_offset_units": dict(ref_offset_units=True),
                 "window_sampling": dict(window_sampling=True)}


def _block_inputs(seed, h=8, w=12):
    rng = np.random.default_rng(seed)
    maps = [rng.normal(size=(1, h, w, 16)).astype(np.float32) for _ in range(3)]
    flows = [rng.normal(0, 2.0, (1, h, w, 2)).astype(np.float32) for _ in range(2)]
    return maps + flows


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("option", list(BLOCK_OPTIONS))
def test_block_option_matches_jax(option):
    kw = dict(n_samples=4, n_groups=4, n_heads=4, offset_scale=2.0, **BLOCK_OPTIONS[option])
    inputs = _block_inputs(2)
    jmod = jnn.CrossDeformableAttentionBlock(16, 16, **kw)
    # The port's initialisation (held to flax's by the init test below) in
    # flax's layout, plus noise, so the zero-initialised convs act.
    torch.manual_seed(2)
    port = pnn.CrossDeformableAttentionBlock(16, 16, **kw)
    params = perturbed(params_to_flax(dict(port.named_parameters()), port), seed=3, scale=0.1)
    port.load_state_dict(params_from_flax(params, port))

    # fp32 forward, and the gradient of a seeded weighting of the outputs.
    def forward_and_vjp(p, xs, weights):
        out, vjp = jax.vjp(lambda p, xs: _tuple(jmod.apply(p, *xs)), p, xs)
        return out, vjp(tuple(weights))

    shapes = jax.eval_shape(lambda p, xs: _tuple(jmod.apply(p, *xs)), params, inputs)
    weights = [np.random.default_rng(4).normal(size=r.shape).astype(np.float32) for r in shapes]
    ref, (ref_params, ref_inputs) = jax.jit(forward_and_vjp)(params, inputs, weights)
    xs = [x.requires_grad_() for x in _t(*inputs)]
    out = _tuple(port(*xs))
    assert len(out) == len(ref) == (1 if option == "attn_stride" else 3)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=0, atol=OP_TOL)
    sum((o * w).sum() for o, w in zip(out, _t(*weights))).backward()
    want = params_from_flax(ref_params, port)
    got = torch.cat([p.grad.flatten() for _, p in sorted(port.named_parameters())]).numpy()
    exp = torch.cat([want[k].flatten() for k, _ in sorted(port.named_parameters())]).numpy()
    assert _rel(got, exp) <= BLOCK_GRAD_TOL
    for x, g in zip(xs, ref_inputs):
        assert _rel(x.grad.numpy(), np.asarray(g)) <= BLOCK_GRAD_TOL

    # bf16: the flax module in bf16, the port's cast to bf16, bf16 inputs.
    bf = [jnp.asarray(a, jnp.bfloat16) for a in inputs]
    ref16 = _tuple(jax.jit(jmod.clone(dtype=jnp.bfloat16).apply)(params, *bf))
    port16 = port.to(torch.bfloat16)
    with torch.no_grad():
        out16 = _tuple(port16(*_t(*inputs, dtype=torch.bfloat16)))
    for o, r16, r32 in zip(out16, ref16, ref):
        r16 = np.asarray(r16, np.float32)
        gap = np.abs(r16 - np.asarray(r32)).mean()
        err = np.abs(o.float().numpy() - r16).mean()
        print(f"{option} bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's gap")
        assert gap > 0 and err <= BF16_GAP_SHARE * gap


@pytest.mark.parametrize("kw,h,w", [
    (dict(attn_stride=3, pred_res_flow=False), 8, 12),
    (dict(attn_stride=2), 8, 12),
    (dict(attn_stride=2, pred_res_flow=False, window_sampling=True), 8, 12),
    (dict(window_sampling=True, ref_offset_units=True), 8, 12),
    (dict(attn_stride=2, pred_res_flow=False), 7, 12)],
    ids=["stride3", "stride_with_flow", "stride_with_window", "window_with_ref_units",
         "odd_level"])
def test_block_refusals_match_jax(kw, h, w):
    kw = dict(n_samples=2, n_groups=4, n_heads=4, **kw)
    inputs = _block_inputs(5, h, w)
    with pytest.raises(ValueError):
        jax.eval_shape(jnn.CrossDeformableAttentionBlock(16, 16, **kw).init,
                       jax.random.key(0), *inputs)
    with pytest.raises(ValueError):
        port = pnn.CrossDeformableAttentionBlock(16, 16, **kw)
        with torch.no_grad():
            port(*_t(*inputs))


def test_a_strided_lv3_or_lv2_is_refused_as_in_jax():
    x = np.zeros((1, 32, 32, 3), np.float32)
    for strides in ((2, 1, 1), (1, 2, 1)):
        with pytest.raises(ValueError, match="attn_strides"):
            jax.eval_shape(JaxDAT(**KW, attn_strides=strides).init, jax.random.key(0), x, x,
                           np.full((1, 1, 1, 1), 0.5, np.float32))
        with pytest.raises(ValueError, match="attn_strides"):
            DATwConstantnC(**KW, attn_strides=strides)


# ---------------------------------------------------------------- the arms


@pytest.fixture(scope="module")
def arm_params():
    """Each arm's parameters: the port's initialisation (which
    ``test_init_follows_the_jax_rules`` holds to flax's) in flax's layout,
    plus seeded noise."""
    out = {}
    for arm, kw in ARMS.items():
        torch.manual_seed(0)
        model = DATwConstantnC(**KW, **kw)
        out[arm] = perturbed(params_to_flax(dict(model.named_parameters()), model), seed=6,
                             scale=0.05)
    return out


@pytest.fixture(scope="module")
def arm_apply():
    """Each arm's jitted forward in fp32 with its intermediates
    (``train=True``, whose frame is the ``train=False`` one) and in bf16."""
    return {arm: {torch.float32: jax.jit(
                      lambda p, a, b, t, m=JaxDAT(**KW, **kw): m.apply(p, a, b, t, train=True)),
                  torch.bfloat16: jax.jit(JaxDAT(**KW, **kw, dtype=jnp.bfloat16).apply)}
            for arm, kw in ARMS.items()}


def _port(arm, params, dtype=torch.float32):
    model = DATwConstantnC(**KW, **ARMS[arm], compute_dtype=dtype)
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
@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_matches_jax_in_fp32(arm_params, arm_apply, arm, train):
    params = arm_params[arm]
    batch = _batch(7)
    x0, x1, t = batch["x0"], np.roll(batch["x1"], (2, 3), (1, 2)), batch["t"]
    ref = arm_apply[arm][torch.float32](params, x0, x1, t)
    with torch.no_grad():
        out = _port(arm, params)(*_t(x0, x1, t), train=train)
    pairs = [(out, ref[0])]
    if train:
        pairs = [(out[0], ref[0])] + [(g, r) for k in ("pred_ft0", "pred_ft1")
                                      for g, r in zip(out[1][k], ref[1][k])]
        assert len(pairs) == 9
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())


@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_in_bf16_within_half_of_jaxs_own_gap(arm_params, arm_apply, arm):
    params = arm_params[arm]
    batch = _batch(8)
    x0, x1, t = batch["x0"], batch["x1"], batch["t"]
    ref32 = np.asarray(arm_apply[arm][torch.float32](params, x0, x1, t)[0])
    ref16 = np.asarray(arm_apply[arm][torch.bfloat16](params, x0, x1, t))
    model = _port(arm, params, torch.bfloat16).to(torch.bfloat16)
    with torch.no_grad():
        out = model(*_t(x0, x1, t)).numpy()
    gap = np.abs(ref16 - ref32).mean()
    err = np.abs(out - ref16).mean()
    print(f"{arm} arm bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
    assert gap > 0 and err <= BF16_GAP_SHARE * gap


@pytest.mark.parametrize("arm", ["stride"])
def test_arm_loss_and_gradients_match_jax(arm_params, arm):
    """The stride arm, whose step runs the strided sampler's gradient (the
    movement arm's narrower convs are held with their gradient at the
    block)."""
    params = arm_params[arm]
    batch = _batch(9)
    loss_fn = jax_make_loss_fn(JaxDAT(**KW, **ARMS[arm]), JaxConfig())
    (_, ref_log), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    model = _port(arm, params)
    total, log = make_loss_fn(model, Config())({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert set(log) == set(ref_log) == {"total_loss", "l1_loss", "census_loss", "flow_loss"}
    for key, value in log.items():
        want = float(ref_log[key])
        assert want > 0 and abs(value.item() - want) <= LOSS_TOL * want, key
    ref = params_from_flax(ref_grads, model)
    got = torch.cat([p.grad.flatten() for _, p in sorted(model.named_parameters())])
    want = torch.cat([ref[k].flatten() for k, _ in sorted(model.named_parameters())])
    err = ((got - want).norm() / want.norm()).item()
    print(f"{arm} arm loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL


@pytest.mark.parametrize("arm", list(ARMS))
def test_flax_round_trip_is_exact(arm_params, arm):
    params = arm_params[arm]
    model = DATwConstantnC(**KW, **ARMS[arm])
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)


def test_init_follows_the_jax_rules():
    """A block with both new architectures (a stride of 2 and a narrower
    movement extractor) at the flagship's width: the same parameters as
    flax's, zero biases, PReLU at 0.25, the zero-initialised offset and
    detail convs at zero, and every other kernel of 1,000 or more values
    with the spread of flax's initialisation (std within 20%)."""
    kw = dict(n_samples=16, n_groups=8, n_heads=8, offset_scale=8.0, pred_res_flow=False,
              attn_stride=2, movement_nf=36)
    rng = np.random.default_rng(10)
    inputs = [rng.normal(size=(1, 8, 8, c)).astype(np.float32) for c in (72, 72, 72, 2, 2)]
    torch.manual_seed(0)
    model = pnn.CrossDeformableAttentionBlock(72, 72, **kw)
    ref = params_from_flax(jax_init(jnn.CrossDeformableAttentionBlock(72, 72, **kw), *inputs),
                           model)
    assert ref.keys() == dict(model.named_parameters()).keys()
    assert {"attn_upsample.weight", "conv_detail.weight"} <= ref.keys()
    assert model.movement_conv1.conv.out_channels == 72
    for name, p in model.named_parameters():
        r = ref[name]
        assert p.shape == r.shape, name
        if name.endswith("alpha"):
            assert torch.equal(p, r), name
        if name.endswith("bias") or "conv_res_offset" in name or "conv_detail" in name:
            assert not p.any() and not r.any(), name
        if r.numel() >= 1000 and r.std() > 0:
            assert 0.8 <= (p.std() / r.std()).item() <= 1.25, name


@pytest.mark.parametrize("overrides,count", [
    ({"dat_samples": (8, 8, 16), "dat_attn_stride": (1, 1, 2)}, 4_712_375),
    ({"dat_samples": (8, 8, 2), "dat_movement_nf": (72, 72, 36)}, 4_275_595)],
    ids=["stride", "movement"])
def test_full_width_parameter_counts(overrides, count):
    """Both arms at nf 72 with 5 and 10 residual blocks: the counts of the
    quality study's records (``n_params``)."""
    model = create_model(Config(shared_offsets=True, **overrides), torch.float32)
    assert sum(p.numel() for p in model.parameters()) == count


# ---------------------------------------------------------------- the entry points


def test_head_to_head_takes_the_seven_options(tmp_path, monkeypatch):
    """Two steps with all seven options at once (a teacher of another
    width): the JAX tool's tag, its parts in its order, and the
    architecture, pool and teacher they ask for."""
    teacher_cfg = Config(nf=8, compute_dtype="float32", shared_offsets=True,
                         dat_samples=(4, 4, 2))
    teacher = write_tiny_checkpoint(tmp_path / "teacher.ckpt", seed=1, cfg=teacher_cfg)
    pools, loaded = [], []
    build_pool, load_model = head_to_head.build_pool, head_to_head.load_model
    monkeypatch.setattr(head_to_head, "build_pool",
                        lambda *a, **kw: pools.append(kw) or build_pool(*a, **kw))
    monkeypatch.setattr(head_to_head, "load_model",
                        lambda cfg, *a, **kw: loaded.append(cfg) or load_model(cfg, *a, **kw))
    out = head_to_head.main([
        "--model", "DATwConstantnCv1", "--shared_levels", "2,1", "--samples", "4,4,8",
        "--attn_stride", "2", "--movement_nf", "16,16,8", "--dec_res_blocks", "1",
        "--random_t", "0.1,0.9", "--host_pool", "--distill_from", str(teacher),
        "--teacher_nf", "8", "--teacher_shared", "--teacher_samples", "4,4,2",
        "--distill_w", "1.0", "--nf", "16", "--crop", "32", "--pool", "4", "--eval_items", "2",
        "--batch", "2", "--steps", "2", "--chunk", "1", "--eval_every", "2", "--warmup", "1",
        "--device", "cpu", "--out_dir", str(tmp_path / "runs")])
    tag = "DATwConstantnCv1_shared21_s4-4-8_stride2_mv16-16-8_dec1_distill1.0T4-4-2_nf16_rt1-9_0k"
    assert out["tag"] == tag
    assert [r["event"] for r in out["records"]] == ["start", "eval", "final"]
    assert int(read_flax_state(tmp_path / "runs" / f"{tag}.ckpt")["step"]) == 2
    model = out["state"].model
    assert [getattr(model, f"dat_lv{i}").n_offset_sets for i in (3, 2, 1)] == [4, 1, 1]
    assert model.dat_lv1.attn_stride == 2 and hasattr(model.dat_lv1, "conv_detail")
    assert [getattr(model, f"dat_lv{i}").movement_conv2.conv.out_channels
            for i in (3, 2, 1)] == [16, 16, 8]
    assert len(model.pixel_generator.reconstruction) == 1
    assert pools[0]["random_t"] == (0.1, 0.9) and "random_t" not in pools[1]
    assert (loaded[0].nf, loaded[0].dat_samples, loaded[0].dec_res_blocks,
            loaded[0].dat_attn_stride, loaded[0].dat_movement_nf) == (8, (4, 4, 2), 10,
                                                                      (1, 1, 1), None)


def test_host_pool_batches_are_the_device_pools():
    pool = head_to_head.build_pool(4, (16, 16), 42, is_train=True, random_t=(0.1, 0.9))
    assert len({float(t) for t in pool["t"].ravel()}) == 4
    on_device = {k: torch.from_numpy(v) for k, v in pool.items()}
    idx = np.array([3, 1, 3])
    host, dev = (head_to_head.take_batch(p, idx, torch.device("cpu")) for p in (pool, on_device))
    assert host.keys() == dev.keys() and all(torch.equal(host[k], dev[k]) for k in host)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A small DAT's checkpoint and YAML, and a Vimeo90K-layout test tree."""
    base = tmp_path_factory.mktemp("window")
    ckpt = write_tiny_checkpoint(base / "tiny.ckpt")
    TINY.save_yaml(base / "tiny.yaml")
    fixtures.write_vimeo90k(base, [(64, 96)] * 2, 3)
    return base, ckpt


def test_evaluate_and_interpolate_with_window_sampling_equal_the_runs_without(
        tiny_run, monkeypatch):
    base, ckpt = tiny_run
    flags = []
    load_model = interpolate.load_model

    def recording(cfg, *args, **kwargs):
        flags.append(cfg.window_sampling)
        return load_model(cfg, *args, **kwargs)

    monkeypatch.setattr(evaluate, "load_model", recording)
    monkeypatch.setattr(interpolate, "load_model", recording)
    common = ["--config", str(base / "tiny.yaml"), "--ckpt", str(ckpt), "--device", "cpu"]
    scores = [run_in(base, evaluate.main, common + extra) for extra in ([], ["--window_sampling"])]
    assert scores[0] == scores[1] and scores[0]["val/vimeo90k_psnr"] > 0
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    outs = []
    for extra in ([], ["--window_sampling"]):
        outs.append(base / f"mid{len(outs)}.png")
        interpolate.main(common + extra + ["--frame0", str(seq / "im1.png"), "--frame1",
                                           str(seq / "im3.png"), "--out", str(outs[-1])])
    assert outs[0].read_bytes() == outs[1].read_bytes()
    assert flags == [False, True, False, True]


def test_the_four_fields_round_trip_through_a_yaml(tmp_path):
    cfg = Config(dat_attn_stride=(1, 1, 2), dat_movement_nf=(72, 72, 36),
                 dat_ref_offset_units=True, window_sampling=True)
    cfg.save_yaml(tmp_path / "config.yaml")
    back = Config.from_yaml(tmp_path / "config.yaml")
    jax_cfg = JaxConfig.from_yaml(str(tmp_path / "config.yaml"))
    for name in ("dat_attn_stride", "dat_movement_nf", "dat_ref_offset_units",
                 "window_sampling"):
        want = getattr(cfg, name)
        for got in (getattr(back, name), getattr(jax_cfg, name)):
            assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
                (tuple(want) if isinstance(want, (list, tuple)) else want), name


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_arm_tiles_with_a_flow_aware_overlap(arm):
    """Both arms through ``--tile`` (``make_infer``): a 160x256 pair in
    128-px tiles is probed (a 1/4-scale forward), planned (the smallest
    overlap, 64) and blended; every tile's level 1 and the probe's stay
    even, so the stride arm's pool divides them."""
    torch.manual_seed(1)
    model = DATwConstantnC(**KW, **ARMS[arm]).eval()
    f0, f1 = ((np.clip(x[0], 0, 1) * 255).astype(np.uint8) for x in smooth_pair(1, 160, 256, 11))
    infer = interpolate.make_infer(model, 128)
    with pytest.warns(UserWarning, match="overlap 64"):
        tiled = interpolate.interp_pair(model, f0, f1, 0.5, infer=infer)
    assert tiled.shape == (160, 256, 3) and list(infer.plans) == [(64, 32)]
