"""Gradients of the port's ops and modules against ``jax.grad`` (CPU, fp32).

Each case draws its inputs and a cotangent with numpy from a seed, takes
``jax.grad`` of ``sum(f(inputs) * cotangent)`` with respect to every input
(and, for modules, every parameter, perturbed by seeded noise so that the
zero-initialised convs are not zero), and holds the port's autograd
gradient of the same function to it.

Tolerance: for each gradient tensor of an op, max |port - JAX| at most 1e-5
of its max |JAX| (``REL_TOL``); the two frameworks sum in different orders.
Modules chain several convolutions (and, in the attention block, the
sampler's coordinate gradient through the offset convs), each summing in
its framework's order, so their gradients are held to 1e-4
(``MODULE_TOL``). A gradient below 1% of the largest of its case
(``FLOOR``) is held to the tolerance of that 1% instead: the key
projection's bias has a gradient that is zero in exact arithmetic (the
softmax ignores a shift shared by all keys), so both sides hold only
rounding noise there.

Tie cases: where a coordinate sits exactly on a border bound
(``grid_sample``'s border clamp), a PReLU input is exactly 0, or the
generator's output is exactly 0 or 1 (its clip), JAX passes half the
gradient to each side (``jnp.clip``, ``jnp.maximum``/``jnp.minimum``); the
port's ``torch.maximum``/``torch.minimum`` do the same, where
``torch.clamp`` would pass all of it. Each tie case checks that the inputs
really hit the tie, and that the gradient there is JAX's 0.5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_tiny import jax_init
from videoframeinterpolation_tpu import nn as jnn
from videoframeinterpolation_tpu import ops as jops
from videoframeinterpolation_tpu.nn.deformable_attn import (
    _grouped_deformable_sample as jax_grouped_sample)
from videoframeinterpolation_tpu_torch import nn as pnn
from videoframeinterpolation_tpu_torch import ops as pops
from videoframeinterpolation_tpu_torch.interop import params_from_flax
from videoframeinterpolation_tpu_torch.kernels import deformable_sample, deformable_sample_plain

REL_TOL = 1e-5
MODULE_TOL = 1e-4
FLOOR = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, ref, name: str = "", largest: float = 0.0,
           tol: float = REL_TOL) -> None:
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), FLOOR * largest)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{name}: max abs {err} > {tol} x {scale}"


def _close_all(pairs: dict, tol: float) -> None:
    """``name -> (port gradient, JAX gradient)`` of one case."""
    largest = max(float(np.abs(np.asarray(r)).max()) for _, r in pairs.values())
    for name, (got, ref) in pairs.items():
        _close(got, ref, name, largest, tol)


def _port_grads(fn, inputs, cot):
    """Port gradients of ``sum(fn(*inputs) * cot)`` with respect to each input."""
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (fn(*ts) * torch.from_numpy(cot)).sum().backward()
    return [t.grad for t in ts]


def _jax_grads(fn, inputs, cot):
    return jax.jit(jax.grad(lambda *xs: jnp.sum(fn(*xs) * cot),
                            argnums=tuple(range(len(inputs)))))(*inputs)


def _check_op(pfn, jfn, inputs, cot, names):
    for g, r, name in zip(_port_grads(pfn, inputs, cot), _jax_grads(jfn, inputs, cot), names):
        _close(g, r, name)


# ---------------------------------------------------------------- ops


def _grid_coords(rng, B, n, H, W, case):
    if case == "random":
        xy = rng.uniform(-3, [W + 2, H + 2], (B, n, 2))
    elif case == "integer":
        xy = rng.integers(-2, [W + 2, H + 2], (B, n, 2)).astype(np.float64)
    else:   # "bounds": every coordinate on 0 or W-1 / H-1 in one axis or both
        xy = rng.uniform(0.2, [W - 1.2, H - 1.2], (B, n, 2))
        pick = rng.integers(0, 3, (B, n, 2))
        xy = np.where(pick == 0, 0.0, np.where(pick == 1, [W - 1.0, H - 1.0], xy))
    return xy.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "integer", "bounds"])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_gradient_matches_jax(mode, case):
    rng = np.random.default_rng(0)
    B, H, W, C, n = 2, 7, 9, 5, 61
    img = _rand(rng, B, H, W, C)
    coords = _grid_coords(rng, B, n, H, W, case)
    cot = _rand(rng, B, n, C)
    _check_op(lambda i, c: pops.grid_sample(i, c, padding_mode=mode),
              lambda i, c: jops.grid_sample(i, c, padding_mode=mode),
              [img, coords], cot, ["img", "coords"])


def test_border_clamp_passes_half_the_gradient_at_a_bound():
    """A coordinate exactly on a border bound: the clamp passes half the
    gradient, as ``jnp.clip`` does (``torch.clamp`` would pass all of it)."""
    H, W = 4, 5
    img = torch.arange(H * W, dtype=torch.float32).reshape(1, H, W, 1)   # value = 5y + x
    coords = torch.tensor([[[0.0, 1.5], [W - 1.0, 1.5], [2.5, H - 1.0], [W + 1.0, 1.5]]],
                          requires_grad=True)
    pops.grid_sample(img, coords, padding_mode="border").sum().backward()
    ref = jax.grad(lambda c: jnp.sum(jops.grid_sample(img.numpy(), c, padding_mode="border")))(
        coords.detach().numpy())
    dx = coords.grad[0, :, 0]
    # d value / d x is 1 inside; at x == 0 the clamp passes half of it. At
    # x == W - 1 the floor puts the right-hand tap outside the image, whose
    # value the border repeats, so the slope there is 0 on both sides.
    assert dx.tolist() == [0.5, 0.0, 1.0, 0.0]
    np.testing.assert_array_equal(coords.grad.numpy(), np.asarray(ref))


@pytest.mark.parametrize("out_hw", [(13, 5), (16, 24), (4, 6)])
def test_resize_bilinear_gradient_matches_jax(out_hw):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 12, 3, scale=2.0)
    cot = _rand(rng, 2, *out_hw, 3)
    _check_op(lambda a: pops.resize_bilinear(a, out_hw), lambda a: jops.resize_bilinear(a, out_hw),
              [x], cot, ["x"])


@pytest.mark.parametrize("scale", [2.0, 16.0, 0.5])
def test_scale_resize_gradient_matches_jax(scale):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 4, 6, 2, scale=3.0)
    cot = _rand(rng, 2, int(4 * scale), int(6 * scale), 2)
    _check_op(lambda a: pops.scale_resize(a, scale), lambda a: jops.scale_resize(a, scale),
              [x], cot, ["x"])


def test_deform_conv2d_gradient_matches_jax():
    rng = np.random.default_rng(3)
    B, H, W, Cin, Cout, G = 2, 6, 7, 16, 8, 8
    x = _rand(rng, B, H, W, Cin)
    offset = _rand(rng, B, H, W, G, 9, 2, scale=2.5)
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    weight = _rand(rng, G, 9, Cin // G, Cout // G, scale=0.3)
    bias = _rand(rng, Cout)
    cot = _rand(rng, B, H, W, Cout)
    _check_op(pops.deform_conv2d, jops.deform_conv2d, [x, offset, mask, weight, bias], cot,
              ["x", "offset", "mask", "weight", "bias"])


@pytest.mark.parametrize("G,S,scale", [(1, 8, 2.0), (4, 3, 30.0), (8, 5, 4.0)])
def test_deformable_sample_plain_gradient_matches_jax(G, S, scale):
    """The sampler's plain version (what autograd differentiates on the CPU)
    against ``jax.grad`` of the model's ``_grouped_deformable_sample`` at
    ``residual + flow``; ``flow``'s gradient is the sum over (G, S)."""
    rng = np.random.default_rng(4)
    B2, H, W, C = 2, 6, 9, 16
    feat = _rand(rng, B2, H, W, C)
    flow = _rand(rng, B2, H, W, 2, scale=3.0)
    res = (scale * np.tanh(_rand(rng, B2, H, W, G, S, 2))).astype(np.float32)
    cot = _rand(rng, B2, S, H * W, C)
    _check_op(lambda f, fl, r: deformable_sample_plain(f, fl, r, G),
              lambda f, fl, r: jax_grouped_sample(f, r + fl[:, :, :, None, None, :], G),
              [feat, flow, res], cot, ["feat", "flow", "residual"])


def test_deformable_sample_on_the_cpu_is_differentiable():
    """The wrapper on CPU tensors runs the plain version under autograd:
    the same gradients, and no kernel launch of either direction."""
    rng = np.random.default_rng(5)
    inputs = [_rand(rng, 1, 5, 6, 8), _rand(rng, 1, 5, 6, 2), _rand(rng, 1, 5, 6, 2, 3, 2)]
    cot = _rand(rng, 1, 3, 30, 8)
    before = (deformable_sample.launches, deformable_sample.backward_launches)
    got = _port_grads(lambda f, fl, r: deformable_sample(f, fl, r, 2), inputs, cot)
    ref = _port_grads(lambda f, fl, r: deformable_sample_plain(f, fl, r, 2), inputs, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (deformable_sample.launches, deformable_sample.backward_launches) == before


# ---------------------------------------------------------------- modules


def _check_module(jax_module, port_module, inputs, seed, noise=0.1, params=None):
    """Gradients of ``sum(module(*inputs) * cot)`` with respect to the
    inputs and every parameter, flax against the port (same parameters)."""
    rng = np.random.default_rng(seed)
    if params is None:
        params = jax_init(jax_module, *inputs)["params"]
        params = jax.tree_util.tree_map(
            lambda p: np.asarray(p) + rng.normal(0, noise, p.shape).astype(np.float32), params)
    out = jax.eval_shape(jax_module.apply, {"params": params}, *inputs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [_rand(rng, *o.shape) for o in outs]

    def jloss(p, *xs):
        o = jax_module.apply({"params": p}, *xs)
        return sum(jnp.sum(a * c) for a, c in zip(o if isinstance(o, tuple) else (o,), cots))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(len(inputs) + 1))))(params, *inputs)
    port_module.load_state_dict(params_from_flax({"params": params}, port_module))
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    o = port_module(*ts)
    sum((a * torch.from_numpy(c)).sum() for a, c in zip(o if isinstance(o, tuple) else (o,),
                                                          cots)).backward()
    ref = params_from_flax({"params": jg[0]}, port_module)
    _close_all({**{f"input {i}": (t.grad, r) for i, (t, r) in enumerate(zip(ts, jg[1:]))},
                **{name: (p.grad, ref[name]) for name, p in port_module.named_parameters()}},
               MODULE_TOL)
    return params, port_module, ts


def test_prelu_passes_half_the_gradient_at_zero():
    """``max(x, 0) + alpha min(x, 0)`` at x == 0: each side gets half the
    gradient, ``(1 + alpha) / 2``, as in JAX (``torch.clamp_min``/``clamp_max``
    would give 1)."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 3, 4, 5)
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :2] = 0.0
    _, port, _ = _check_module(jnn.PReLU(5), pnn.PReLU(5), [x], seed=6)
    tx = torch.from_numpy(x).requires_grad_()
    port(tx).sum().backward()
    half = (1 + port.alpha.detach()) / 2
    assert torch.equal(tx.grad[0, 0, 0], half)
    assert torch.equal(tx.grad[1, 2, 3, :2], half[:2])


def test_generator_clip_passes_half_the_gradient_at_its_bounds():
    """The generator's ``clip(h + mean, 0, 1)`` where ``h + mean`` is exactly
    0 or 1 (``conv_last`` zero but for its bias): JAX's ``jnp.clip`` passes
    half the gradient there, and so does the port."""
    rng = np.random.default_rng(7)
    nf = 8
    feat = _rand(rng, 1, 4, 4, nf)
    mean = np.full((1, 1, 1, 1), 0.25, np.float32)
    jmod = jnn.BasicResPixelShuffleGenerator(nf, 1)
    params = jax_init(jmod, feat, mean)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.1, p.shape).astype(np.float32), params)
    params["conv_last"]["kernel"] = np.zeros_like(params["conv_last"]["kernel"])
    # rgb + mean: 1.0 (upper bound), 0.0 (lower bound), 0.5 (inside).
    params["conv_last"]["bias"] = np.asarray([0.75, -0.25, 0.25], np.float32)
    out = np.asarray(jmod.apply({"params": params}, feat, mean))
    assert (out[..., 0] == 1.0).all() and (out[..., 1] == 0.0).all()
    _, port, _ = _check_module(jmod, pnn.BasicResPixelShuffleGenerator(nf, 1), [feat, mean],
                               seed=7, params=params)
    # d sum(out) / d bias: half of each pixel's 1 on the tied channels.
    port.zero_grad()
    port(torch.from_numpy(feat), torch.from_numpy(mean)).sum().backward()
    n = out[..., 0].size
    assert port.conv_last.bias.grad.tolist() == [0.5 * n, 0.5 * n, float(n)]


def test_res_block_gradient_matches_jax():
    rng = np.random.default_rng(8)
    _check_module(jnn.ResBlocks(8, 2), pnn.ResBlocks(8, 2), [_rand(rng, 2, 6, 5, 8)], seed=8)


def test_half_channel_conv5_res_block_gradient_matches_jax():
    rng = np.random.default_rng(9)
    _check_module(jnn.HalfChannelConv5ResBlock(8, 4), pnn.HalfChannelConv5ResBlock(8, 4),
                  [_rand(rng, 2, 6, 5, 8)], seed=9)


def test_deformable_conv_layer_gradient_matches_jax():
    rng = np.random.default_rng(10)
    x, mv = _rand(rng, 2, 6, 7, 16), _rand(rng, 2, 6, 7, 16)
    _check_module(jnn.DeformableConv2d(16), pnn.DeformableConv2d(16, 16, 16), [x, mv], seed=10)


def test_sample_attention_gradient_matches_jax():
    rng = np.random.default_rng(11)
    q, kv = _rand(rng, 2, 4, 5, 16), _rand(rng, 2, 6, 20, 16)
    _check_module(jnn.SampleAttention(16, 6, 4), pnn.SampleAttention(16, 16, 6, 4), [q, kv],
                  seed=11)


@pytest.mark.parametrize("shared_offsets,pred_res_flow", [(True, True), (False, False)])
def test_cross_deformable_attention_block_gradient_matches_jax(shared_offsets, pred_res_flow):
    rng = np.random.default_rng(12)
    B, H, W, C = 1, 8, 10, 16
    inputs = [_rand(rng, B, H, W, C), _rand(rng, B, H, W, C), _rand(rng, B, H, W, C),
              _rand(rng, B, H, W, 2, scale=2.0), _rand(rng, B, H, W, 2, scale=2.0)]
    kw = dict(n_samples=3, n_groups=4, n_heads=4, offset_scale=2.0,
              pred_res_flow=pred_res_flow, shared_offsets=shared_offsets)
    _check_module(jnn.CrossDeformableAttentionBlock(C, C, **kw),
                  pnn.CrossDeformableAttentionBlock(C, C, **kw), inputs, seed=12)
