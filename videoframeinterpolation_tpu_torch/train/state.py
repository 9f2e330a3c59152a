"""Train state and optimizer (counterpart of ``videoframeinterpolation_tpu/train/state.py``).

The JAX package trains with ``optax.adamw`` (betas 0.9/0.999, eps 1e-8
outside the square root, decoupled weight decay on every parameter) over
the warmup-cosine schedule, in a flax ``TrainState``. :class:`AdamW`
repeats optax's arithmetic step for step, in float32:

  * ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 + b2 nu``;
  * bias correction with the incremented count, ``1 - b^(count + 1)``;
  * ``u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p``;
  * ``p += -lr * u``, the learning rate taken from the schedule at the
    count *before* the update (``optax.scale_by_schedule``), so the first
    update of a fresh state uses ``lr(0)``, which is 0 under warmup.

With ``grad_clip`` set, the JAX package chains
``optax.clip_by_global_norm(grad_clip)`` before AdamW: where the global
L2 norm of the gradient is not below ``grad_clip``, every gradient becomes
``(g / norm) * grad_clip``. :class:`AdamW` does the same with
``clip_norm``, on the card without reading the norm back to the host.

``torch.optim.AdamW`` differs from this (its bias correction and decay
order, and a ``LambdaLR`` one step ahead), hence a class of its own. The
update is in place (PyTorch's tensors are mutable; the JAX state is
rebuilt each step), over ``torch._foreach_*`` so that a step costs a few
launches and not one per parameter.

:class:`TrainState` maps one to one onto the flax ``TrainState`` that
``tools/quality/head_to_head.py`` checkpoints: ``step``, ``params`` (the
model's fp32 master parameters) and ``opt_state`` = (adam ``count``,
``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``), optax's empty
decay state, and the schedule's ``count``; with ``grad_clip``, the chain's
``(clip state, adamw state)``, the clip's state empty. :func:`state_to_flax` and
:func:`state_from_flax` carry it across (``train/checkpoint.py`` writes
and reads the bytes).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..interop import params_from_flax, params_to_flax
from .schedule import make_schedule


@dataclasses.dataclass
class AdamWState:
    count: int                              # optax ScaleByAdamState.count
    exp_avg: dict[str, torch.Tensor]        # mu
    exp_avg_sq: dict[str, torch.Tensor]     # nu
    schedule_count: int                     # optax ScaleByScheduleState.count


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay)`` on named fp32
    tensors, after ``optax.clip_by_global_norm(clip_norm)`` where
    ``clip_norm`` is given."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float | None = None):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_norm = clip_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamWState(0, zeros, {k: z.clone() for k, z in zeros.items()}, 0)

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
               state: AdamWState) -> None:
        """One optimizer step: updates ``params`` and ``state`` in place."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.clip_norm is not None:
            g = clip_by_global_norm(g, self.clip_norm)
        mu = [state.exp_avg[k] for k in names]
        nu = [state.exp_avg_sq[k] for k in names]
        f32 = np.float32
        lr = float(self.schedule(state.schedule_count))
        count = state.count + 1
        # optax: decay ** count in float32, then 1 - that.
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))

        # (1 - b) * g^k + b * moment, each product rounded before the sum.
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        del g2
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)
        state.count = count
        state.schedule_count += 1


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients as they are where their
    global L2 norm is below ``max_norm``, else each ``(g / norm) * max_norm``.
    The norm stays on the device (no host read)."""
    norm = torch.stack([torch.sum(x * x) for x in grads]).sum().sqrt()
    keep = norm < max_norm
    return [torch.where(keep, x, (x / norm) * max_norm) for x in grads]


def create_optimizer(cfg: Config) -> AdamW:
    """AdamW over the warmup-cosine schedule of ``cfg``, with ``grad_clip``
    chained before it (JAX ``create_optimizer``)."""
    schedule = make_schedule(cfg.start_lr, cfg.end_lr, cfg.last_lr_decay_iter,
                             cfg.warmup_steps)
    return AdamW(schedule, cfg.weight_decay, clip_norm=cfg.grad_clip)


@dataclasses.dataclass
class TrainState:
    """``step`` (optimizer updates applied), the model that holds the fp32
    master ``params``, the optimizer and its state."""

    step: int
    model: nn.Module
    tx: AdamW
    opt_state: AdamWState

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def apply_gradients(self) -> None:
        """One optimizer step from the gradients autograd left in the
        parameters' ``.grad`` (a parameter without one gets zero, as
        ``jax.grad`` gives an unused parameter), then clear them."""
        params = self.params
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        self.tx.update(params, grads, self.opt_state)
        for p in params.values():
            p.grad = None
        self.step += 1


def create_train_state(model: nn.Module, cfg: Config) -> TrainState:
    """A fresh state: step 0, zero moments (JAX ``create_train_state``)."""
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise TypeError(f"parameter {name} is {p.dtype}; training keeps fp32 master "
                            "parameters (create_model(cfg, torch.float32))")
    tx = create_optimizer(cfg)
    return TrainState(0, model, tx, tx.init(dict(model.named_parameters())))


def _count(n: int) -> np.ndarray:
    return np.asarray(n, dtype=np.int32)


def state_to_flax(state: TrainState) -> dict:
    """The flax ``TrainState`` tree of ``state`` (``{"step", "params",
    "opt_state"}``), as :func:`..train.checkpoint.write_flax_state` writes it."""
    model, opt = state.model, state.opt_state
    adamw = {
        "0": {"count": _count(opt.count), "mu": params_to_flax(opt.exp_avg, model),
              "nu": params_to_flax(opt.exp_avg_sq, model)},
        "1": {},
        "2": {"count": _count(opt.schedule_count)},
    }
    return {
        "step": _count(state.step),
        "params": params_to_flax(state.params, model),
        "opt_state": adamw if state.tx.clip_norm is None else {"0": {}, "1": adamw},
    }


def state_from_flax(tree: Mapping, state: TrainState) -> None:
    """Load a flax ``TrainState`` tree (as :func:`..train.checkpoint.read_flax_state`
    returns it) into ``state``: the model's parameters, the moments and
    the counts, each leaf through the layout rules of ``interop``."""
    opt = tree["opt_state"]
    if state.tx.clip_norm is not None:
        if set(opt) != {"0", "1"} or opt["0"]:
            raise ValueError("opt_state is not optax.chain(clip_by_global_norm, adamw)'s "
                             "(the config sets grad_clip)")
        opt = opt["1"]
    if set(opt) != {"0", "1", "2"} or opt["1"] or set(opt["0"]) != {"count", "mu", "nu"}:
        raise ValueError("opt_state is not optax.adamw's (scale_by_adam, "
                         "add_decayed_weights, scale_by_schedule)")
    model = state.model
    device = next(model.parameters()).device
    model.load_state_dict(params_from_flax(tree["params"], model))
    for moments, key in ((state.opt_state.exp_avg, "mu"), (state.opt_state.exp_avg_sq, "nu")):
        for name, value in params_from_flax(opt["0"][key], model).items():
            moments[name] = value.to(device, torch.float32)
    state.step = int(tree["step"])
    state.opt_state.count = int(opt["0"]["count"])
    state.opt_state.schedule_count = int(opt["2"]["count"])
