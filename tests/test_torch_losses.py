"""The port's losses, schedule and optimizer against the JAX package and optax (CPU, fp32).

Tolerances:
  * each loss's value within 1e-5 relative (``LOSS_TOL``), and its gradient
    with respect to the prediction within 1e-5 of the gradient's max abs;
  * the learning rate at each step within 1e-6 relative (``LR_TOL``): the
    port computes it in float32 as JAX does, and may differ by one float32
    ulp where XLA's cosine does;
  * one AdamW step against ``optax.adamw`` (through the JAX package's
    ``create_optimizer``): parameters, ``mu`` and ``nu`` within 1e-6
    relative (``ADAM_TOL``), from a fresh state and from a state with
    nonzero moments and count.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.ops import losses as jlosses
from videoframeinterpolation_tpu.train.schedule import warmup_cosine_lr as jax_lr
from videoframeinterpolation_tpu.train.state import create_optimizer as jax_optimizer
from videoframeinterpolation_tpu.models.dat import dat_loss as jax_dat_loss
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.models import dat_loss
from videoframeinterpolation_tpu_torch.ops import losses
from videoframeinterpolation_tpu_torch.train import AdamW, create_optimizer, warmup_cosine_lr

LOSS_TOL = 1e-5
LR_TOL = 1e-6
ADAM_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check_loss(pfn, jfn, pred, *rest):
    """Value and gradient (with respect to ``pred``) of a scalar loss."""
    ref, ref_grad = jax.jit(jax.value_and_grad(jfn))(pred, *rest)
    p = torch.from_numpy(pred).requires_grad_()
    out = pfn(p, *(torch.from_numpy(r) for r in rest))
    out.backward()
    assert abs(out.item() - float(ref)) <= LOSS_TOL * abs(float(ref))
    ref_grad = np.asarray(ref_grad)
    assert np.abs(p.grad.numpy() - ref_grad).max() <= LOSS_TOL * np.abs(ref_grad).max()


def test_charbonnier_l1_matches_jax():
    rng = np.random.default_rng(0)
    diff = _rand(rng, 2, 8, 8, 3, scale=0.1)
    diff[0, 0, 0] = 0.0
    _check_loss(losses.charbonnier_l1, jlosses.charbonnier_l1, diff)


def test_masked_charbonnier_l1_matches_jax():
    rng = np.random.default_rng(1)
    diff = _rand(rng, 2, 8, 8, 3, scale=0.1)
    mask = (rng.uniform(0, 1, (2, 8, 8, 1)) > 0.3).astype(np.float32)
    _check_loss(losses.charbonnier_l1, jlosses.charbonnier_l1, diff, mask)


def test_charbonnier_ada_matches_jax():
    rng = np.random.default_rng(2)
    diff = _rand(rng, 2, 8, 8, 2, scale=0.5)
    weight = rng.uniform(0.05, 1.0, (2, 8, 8, 1)).astype(np.float32)
    _check_loss(losses.charbonnier_ada, jlosses.charbonnier_ada, diff, weight)


def test_robust_weight_matches_jax_and_passes_no_gradient():
    rng = np.random.default_rng(3)
    pred, gt = _rand(rng, 2, 8, 8, 2), _rand(rng, 2, 8, 8, 2)
    ref = np.asarray(jlosses.get_robust_weight(pred, gt, beta=0.3))
    p = torch.from_numpy(pred).requires_grad_()
    w = losses.get_robust_weight(p, torch.from_numpy(gt), beta=0.3)
    assert not w.requires_grad
    np.testing.assert_allclose(w.numpy(), ref, rtol=LOSS_TOL, atol=0)


@pytest.mark.parametrize("hw", [(16, 16), (9, 13)])
def test_ternary_loss_matches_jax(hw):
    """The census loss with its identity-kernel patches, soft census and
    valid mask; the ground truth side passes no gradient."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    y = np.clip(x + _rand(rng, 2, *hw, 3, scale=0.05), 0, 1).astype(np.float32)
    _check_loss(losses.ternary_loss, jlosses.ternary_loss, x, y)
    ty = torch.from_numpy(y).requires_grad_()
    losses.ternary_loss(torch.from_numpy(x).requires_grad_(), ty).backward()
    assert ty.grad is None


def test_census_patches_and_mask_match_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (1, 9, 11, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        losses._extract_patches(torch.from_numpy(x), 7).numpy(),
        np.asarray(jlosses._extract_patches(x, 7)))
    np.testing.assert_array_equal(
        losses._valid_mask(x.shape, 7, torch.float32, "cpu").numpy(),
        np.asarray(jlosses._valid_mask(x.shape, 7, jnp.float32)))


@pytest.mark.parametrize("distill_lambda", [0.01, None])
def test_dat_loss_matches_jax(distill_lambda):
    """``dat_loss`` on a prediction and four-level flow pyramids: every log
    value, and the gradient to the prediction and to each pyramid level."""
    rng = np.random.default_rng(6)
    B, H, W = 2, 16, 16
    batch = {"xt": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "f0x": _rand(rng, B, H, W, 2, scale=0.02), "f1x": _rand(rng, B, H, W, 2, scale=0.02)}
    pred = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    inter = {k: [_rand(rng, B, H, W, 2, scale=0.03) for _ in range(4)]
             for k in ("pred_ft0", "pred_ft1")}

    def jfn(pred, inter):
        return jax_dat_loss(pred, inter, batch, distill_lambda)

    (jtotal, jlog), (jg_pred, jg_inter) = jax.jit(
        jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(pred, inter)
    tp = torch.from_numpy(pred).requires_grad_()
    tinter = {k: [torch.from_numpy(a).requires_grad_() for a in v] for k, v in inter.items()}
    total, log = dat_loss(tp, tinter, {k: torch.from_numpy(v) for k, v in batch.items()},
                          distill_lambda)
    total.backward()
    assert set(log) == set(jlog)
    for k in log:
        assert abs(log[k].item() - float(jlog[k])) <= LOSS_TOL * abs(float(jlog[k])), k
    pairs = [(tp.grad, jg_pred)] + [(t.grad, j) for k in tinter
                                    for t, j in zip(tinter[k], jg_inter[k])]
    for got, ref in pairs:
        ref = np.asarray(ref)
        if not ref.any():   # level 1's flow reaches the loss only through the detached weight
            assert got is None
            continue
        assert np.abs(got.numpy() - ref).max() <= LOSS_TOL * np.abs(ref).max()


@pytest.mark.parametrize("warmup,last", [(2000, 600_000), (500, 24_000)])
def test_warmup_cosine_lr_matches_jax(warmup, last):
    steps = [0, 1, warmup - 1, warmup, warmup + 1, (warmup + last) // 2, 14_500, last - 1,
             last, last + 1, 10 * last]
    for step in steps:
        ours = float(warmup_cosine_lr(step, 2e-4, 1e-5, last, warmup))
        ref = float(jax_lr(step, 2e-4, 1e-5, last, warmup))
        assert abs(ours - ref) <= LR_TOL * abs(ref), (step, ours, ref)
    assert warmup_cosine_lr(0, 2e-4, 1e-5, last, warmup) == 0.0


def _adam_case(rng, shapes, count):
    params = {k: _rand(rng, *s, scale=0.1) for k, s in shapes.items()}
    grads = {k: _rand(rng, *s, scale=0.01) for k, s in shapes.items()}
    if count == 0:
        mu = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        nu = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    else:
        mu = {k: _rand(rng, *s, scale=0.003) for k, s in shapes.items()}
        nu = {k: (_rand(rng, *s, scale=0.01) ** 2).astype(np.float32) for k, s in shapes.items()}
    return params, grads, mu, nu


@pytest.mark.parametrize("count,warmup", [(0, 500), (0, 0), (14_500, 500), (3, 2000)])
def test_adamw_step_matches_optax(count, warmup):
    """One step of :class:`AdamW` against ``optax.adamw`` as the JAX package
    builds it, from a fresh state (``count`` 0: under warmup the first
    update has lr(0) = 0 and only the moments move) and from states with
    nonzero moments and count."""
    rng = np.random.default_rng(7 + count)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}
    params, grads, mu, nu = _adam_case(rng, shapes, count)
    jcfg = dataclasses.replace(JaxConfig(), start_lr=2e-4, end_lr=1e-5,
                               last_lr_decay_iter=24_000, warmup_steps=warmup)
    tx = jax_optimizer(jcfg)
    state = tx.init(params)
    adam = state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
    state = (adam, state[1], state[2]._replace(count=jnp.asarray(count, jnp.int32)))
    updates, new_state = tx.update(grads, state, params)
    ref_params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)

    cfg = dataclasses.replace(Config(), start_lr=2e-4, end_lr=1e-5, last_lr_decay_iter=24_000,
                              warmup_steps=warmup)
    ours = create_optimizer(cfg)
    assert isinstance(ours, AdamW)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ostate = ours.init(tparams)
    ostate.count = ostate.schedule_count = count
    ostate.exp_avg = {k: torch.from_numpy(v.copy()) for k, v in mu.items()}
    ostate.exp_avg_sq = {k: torch.from_numpy(v.copy()) for k, v in nu.items()}
    ours.update(tparams, {k: torch.from_numpy(v) for k, v in grads.items()}, ostate)

    assert ostate.count == int(new_state[0].count) == count + 1
    assert ostate.schedule_count == int(new_state[2].count) == count + 1
    for k in shapes:
        for got, ref in ((tparams[k], ref_params[k]), (ostate.exp_avg[k], new_state[0].mu[k]),
                         (ostate.exp_avg_sq[k], new_state[0].nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=ADAM_TOL, atol=0)
    if count == 0 and warmup > 0:
        assert all(np.array_equal(tparams[k].numpy(), params[k]) for k in shapes)


def test_grad_clip_is_not_ported():
    """``grad_clip`` is ported (the name is the test's from before): the
    optimizer chains the global-norm clip before AdamW, and one step from a
    fresh state matches ``optax.chain(clip_by_global_norm, adamw)`` as the
    JAX package builds it, with the clip firing."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}
    params, grads, _, _ = _adam_case(rng, shapes, 0)
    grads = {k: v * np.float32(100.0) for k, v in grads.items()}   # norm above the clip
    jcfg = dataclasses.replace(JaxConfig(), warmup_steps=0, grad_clip=1.0)
    tx = jax_optimizer(jcfg)
    updates, new_state = tx.update(grads, tx.init(params), params)
    ours = create_optimizer(dataclasses.replace(Config(), warmup_steps=0, grad_clip=1.0))
    assert ours.clip_norm == 1.0
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ostate = ours.init(tparams)
    ours.update(tparams, {k: torch.from_numpy(v) for k, v in grads.items()}, ostate)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(params[k] + updates[k]),
                                   rtol=ADAM_TOL, atol=0)
        # The first moment holds the clipped gradient.
        np.testing.assert_allclose(ostate.exp_avg[k].numpy(), np.asarray(new_state[1][0].mu[k]),
                                   rtol=ADAM_TOL, atol=0)
