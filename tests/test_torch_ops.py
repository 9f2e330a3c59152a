"""The port's ops and blocks against the JAX package (CPU, fp32 and bf16).

Each module is initialised by flax, its parameters are perturbed with seeded
noise (so the zero-initialised offset and mask convs are not zero), and the
same parameters go to the port through ``params_from_flax``. Inputs are made
with numpy from a seed and fed to both sides.

Tolerances: 1e-5 max abs for the sampling and resizing ops, whose arithmetic
is the same step for step; 2e-5 for blocks with convolutions, whose sums the
two frameworks take in different orders.

bf16 cases (the JAX module or function jitted with ``dtype=bfloat16``, the
port's module cast to bf16, the same bf16 inputs): at least 99% of the
output elements equal, and none further apart than one bf16 ulp of the
largest output (2^-7 of max |ref|). The port rounds to bf16 where the JAX
code does, so the two agree exactly except where the frameworks' fp32 sums
straddle a bf16 rounding boundary; a rounding step in another place shows
as a far lower share of equal elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_tiny import jax_init
from videoframeinterpolation_tpu import nn as jnn
from videoframeinterpolation_tpu import ops as jops
from videoframeinterpolation_tpu.data.padder import InputPadder as JaxInputPadder
from videoframeinterpolation_tpu.models.base import norm_w_rgb_mean as jax_norm
from videoframeinterpolation_tpu_torch import nn as pnn
from videoframeinterpolation_tpu_torch import ops as pops
from videoframeinterpolation_tpu_torch.data import InputPadder
from videoframeinterpolation_tpu_torch.interop import params_from_flax
from videoframeinterpolation_tpu_torch.models.base import norm_w_rgb_mean

OP_TOL = 1e-5
BLOCK_TOL = 2e-5
BF16_EQUAL_SHARE = 0.99


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(out, ref, tol):
    if isinstance(ref, (tuple, list)):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            _close(o, r, tol)
        return
    out = out.detach().numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def _close_bf16(out, ref):
    if isinstance(ref, (tuple, list)):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            _close_bf16(o, r)
        return
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    out = out.detach().float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.shape == ref.shape
    equal = np.mean(out == ref)
    err = np.abs(out - ref).max()
    print(f"bf16: {equal:.4%} of elements equal, max abs {err:.3e}")
    assert equal >= BF16_EQUAL_SHARE
    assert err <= np.abs(ref).max() * 2.0 ** -7


def _compare_module(jax_module, port_module, inputs, seed, tol=BLOCK_TOL, noise=0.1,
                    bf16=False):
    """Run flax and port modules with identical (perturbed) parameters; with
    ``bf16``, the flax module computes in bf16 (it was built with that
    dtype), the port's module is cast to bf16 and both get the inputs in bf16."""
    rng = np.random.default_rng(seed)
    jin = [jnp.asarray(x, jnp.bfloat16 if bf16 else None) for x in inputs]
    params = jax_init(jax_module, *jin)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, noise, p.shape).astype(np.float32), params)
    ref = jax.jit(jax_module.apply)({"params": params}, *jin)
    if bf16:
        port_module.to(torch.bfloat16)
    port_module.load_state_dict(params_from_flax({"params": params}, port_module))
    with torch.no_grad():
        out = port_module(*[_t(x).to(torch.bfloat16 if bf16 else torch.float32)
                            for x in inputs])
    if bf16:
        _close_bf16(out, ref)
    else:
        _close(out, ref, tol)


# ---------------------------------------------------------------- ops


def test_bwarp_matches_jax():
    rng = np.random.default_rng(0)
    img, flow = _rand(rng, 2, 9, 11, 4), _rand(rng, 2, 9, 11, 2, scale=4.0)
    _close(pops.bwarp(_t(img), _t(flow)), jax.jit(jops.bwarp)(img, flow), OP_TOL)


@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_scale_resize_matches_jax(scale):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 12, 2, scale=3.0)
    _close(pops.scale_resize(_t(x), scale), jops.scale_resize(x, scale), OP_TOL)


def test_resize_bilinear_to_odd_sizes_matches_jax():
    rng = np.random.default_rng(2)
    x = _rand(rng, 1, 7, 10, 3)
    _close(pops.resize_bilinear(_t(x), (13, 5)), jops.resize_bilinear(x, (13, 5)), OP_TOL)


def test_pixel_shuffle_matches_jax():
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    _close(pops.pixel_shuffle(_t(x), 2), jops.pixel_shuffle(x, 2), 0.0)


def test_deform_conv2d_matches_jax():
    rng = np.random.default_rng(3)
    B, H, W, Cin, Cout, G = 2, 6, 7, 16, 8, 8
    x = _rand(rng, B, H, W, Cin)
    offset = _rand(rng, B, H, W, G, 9, 2, scale=2.5)
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    weight = _rand(rng, G, 9, Cin // G, Cout // G, scale=0.3)
    bias = _rand(rng, Cout)
    ref = jax.jit(jops.deform_conv2d)(x, offset, mask, weight, bias)
    out = pops.deform_conv2d(_t(x), _t(offset), _t(mask), _t(weight), _t(bias))
    _close(out, ref, OP_TOL)


def test_deform_conv2d_matches_jax_in_bf16():
    """JAX contracts in fp32 and rounds once to bf16 before the bias; so
    does the port. Weight and bias stay fp32 leaves on both sides."""
    rng = np.random.default_rng(3)
    B, H, W, Cin, Cout, G = 2, 6, 7, 16, 8, 8
    x = jnp.asarray(_rand(rng, B, H, W, Cin), jnp.bfloat16)
    offset = jnp.asarray(_rand(rng, B, H, W, G, 9, 2, scale=2.5), jnp.bfloat16)
    mask = jnp.asarray(rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32), jnp.bfloat16)
    weight = _rand(rng, G, 9, Cin // G, Cout // G, scale=0.3)
    bias = _rand(rng, Cout)
    ref = jax.jit(jops.deform_conv2d)(x, offset, mask, weight, bias)

    def bf(a):
        return _t(np.asarray(a.astype(jnp.float32))).bfloat16()

    out = pops.deform_conv2d(bf(x), bf(offset), bf(mask), _t(weight), _t(bias))
    _close_bf16(out, ref)


def test_norm_w_rgb_mean_matches_jax():
    rng = np.random.default_rng(4)
    x0, x1 = rng.random((2, 8, 8, 3), dtype=np.float32), rng.random((2, 8, 8, 3), dtype=np.float32)
    _close(norm_w_rgb_mean(_t(x0), _t(x1)), jax_norm(x0, x1), OP_TOL)


@pytest.mark.parametrize("hw", [(270, 480), (64, 48), (17, 33)])
def test_input_padder_matches_jax(hw):
    rng = np.random.default_rng(5)
    x = rng.random((1, *hw, 3), dtype=np.float32)
    jp, pp = JaxInputPadder(x.shape), InputPadder(x.shape)
    (padded,), (ref,) = pp.pad(_t(x)), jp.pad(jnp.asarray(x))
    _close(padded, ref, 0.0)
    assert padded.shape[1] % 16 == 0 and padded.shape[2] % 16 == 0
    _close(pp.unpad(padded), jp.unpad(ref), 0.0)


# ---------------------------------------------------------------- blocks


def test_prelu_matches_jax():
    x = np.linspace(-3, 3, 2 * 4 * 5 * 6, dtype=np.float32).reshape(2, 4, 5, 6)
    _compare_module(jnn.PReLU(6), pnn.PReLU(6), [x], seed=10, tol=0.0)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_prelu_matches_jax(stride):
    x = _rand(np.random.default_rng(11), 2, 8, 10, 5)
    _compare_module(jnn.ConvPReLU(8, stride=stride), pnn.ConvPReLU(5, 8, stride=stride),
                    [x], seed=11)


def test_conv_transpose_x2_matches_jax():
    x = _rand(np.random.default_rng(12), 2, 5, 7, 6)
    _compare_module(jnn.conv_transpose_x2(5), pnn.conv_transpose_x2(6, 5), [x], seed=12)


def test_res_blocks_match_jax():
    x = _rand(np.random.default_rng(13), 1, 8, 8, 6)
    _compare_module(jnn.ResBlocks(6, 2), pnn.ResBlocks(6, 2), [x], seed=13)


@pytest.mark.parametrize("final_activation", [True, False])
def test_half_channel_conv5_res_block_matches_jax(final_activation):
    x = _rand(np.random.default_rng(14), 2, 6, 7, 8)
    _compare_module(jnn.HalfChannelConv5ResBlock(8, 4, final_activation=final_activation),
                    pnn.HalfChannelConv5ResBlock(8, 4, final_activation=final_activation),
                    [x], seed=14)


@pytest.mark.parametrize("bf16", [False, True])
def test_feed_forward_matches_jax(bf16):
    x = _rand(np.random.default_rng(15), 2, 5, 3, 6)
    dtype = jnp.bfloat16 if bf16 else None
    _compare_module(jnn.FeedForward(12, 6, dtype=dtype), pnn.FeedForward(6, 12, 6), [x],
                    seed=15, bf16=bf16)


def test_same_channel_res_encoder_matches_jax():
    x = np.random.default_rng(16).random((2, 32, 32, 3), dtype=np.float32)
    _compare_module(jnn.SameChannelResEncoder(8, 1), pnn.SameChannelResEncoder(8, 1),
                    [x], seed=16)


def test_pixel_shuffle_generator_matches_jax():
    rng = np.random.default_rng(17)
    feat, mean = _rand(rng, 1, 8, 8, 8), np.full((1, 1, 1, 1), 0.45, np.float32)
    _compare_module(jnn.BasicResPixelShuffleGenerator(8, 2),
                    pnn.BasicResPixelShuffleGenerator(8, 2), [feat, mean], seed=17)


@pytest.mark.parametrize("bf16", [False, True])
def test_deformable_conv_layer_matches_jax(bf16):
    rng = np.random.default_rng(18)
    x, mv = _rand(rng, 2, 6, 6, 16), _rand(rng, 2, 6, 6, 16)
    dtype = jnp.bfloat16 if bf16 else None
    _compare_module(jnn.DeformableConv2d(16, dtype=dtype), pnn.DeformableConv2d(16, 16, 16),
                    [x, mv], seed=18, bf16=bf16)


def test_query_builder_matches_jax():
    rng = np.random.default_rng(19)
    f0, f1 = _rand(rng, 1, 4, 6, 16), _rand(rng, 1, 4, 6, 16)
    t = np.full((1, 1, 1, 1), 0.3, np.float32)
    _compare_module(jnn.DCNInterFeatBuilderWithT(16), pnn.DCNInterFeatBuilderWithT(16),
                    [f0, f1, t], seed=19)


@pytest.mark.parametrize("bf16", [False, True])
def test_sample_attention_matches_jax(bf16):
    rng = np.random.default_rng(20)
    q, kv = _rand(rng, 2, 4, 5, 8), _rand(rng, 2, 6, 20, 8)
    dtype = jnp.bfloat16 if bf16 else None
    _compare_module(jnn.SampleAttention(8, 6, 2, dtype=dtype), pnn.SampleAttention(8, 8, 6, 2),
                    [q, kv], seed=20, bf16=bf16)


@pytest.mark.parametrize("shared_offsets,pred_res_flow", [(True, True), (False, True),
                                                          (True, False)])
def test_cross_deformable_attention_block_matches_jax(shared_offsets, pred_res_flow):
    rng = np.random.default_rng(21)
    feat_t, f0, f1 = (_rand(rng, 1, 8, 10, 16) for _ in range(3))
    ft0, ft1 = (_rand(rng, 1, 8, 10, 2, scale=2.0) for _ in range(2))
    kw = dict(n_samples=4, n_groups=4, n_heads=4, offset_scale=2.0,
              shared_offsets=shared_offsets, pred_res_flow=pred_res_flow)
    _compare_module(jnn.CrossDeformableAttentionBlock(16, 16, **kw),
                    pnn.CrossDeformableAttentionBlock(16, 16, **kw),
                    [feat_t, f0, f1, ft0, ft1], seed=21)


# ---------------------------------------------------------------- params_from_flax


def _ff_params(seed=0):
    x = jnp.zeros((1, 2, 2, 6))
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jnn.FeedForward(12, 6).init)(jax.random.key(seed), x))


def test_params_from_flax_rejects_leftover_leaf():
    params = _ff_params()
    params["params"]["fc3"] = {"kernel": np.zeros((6, 6), np.float32)}
    with pytest.raises(KeyError, match="fc3"):
        params_from_flax(params, pnn.FeedForward(6, 12, 6))


def test_params_from_flax_rejects_missing_leaf():
    params = _ff_params()
    del params["params"]["fc2"]["bias"]
    with pytest.raises(KeyError, match="fc2.bias"):
        params_from_flax(params, pnn.FeedForward(6, 12, 6))


def test_params_from_flax_rejects_wrong_shape():
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(_ff_params(), pnn.FeedForward(6, 10, 6))
