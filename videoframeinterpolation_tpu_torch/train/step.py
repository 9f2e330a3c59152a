"""Training step (counterpart of ``videoframeinterpolation_tpu/train/step.py``).

The JAX package compiles forward, loss, backward and the AdamW update into
one XLA program per step (or per chunk of steps, ``lax.scan``). PyTorch
runs them eagerly, one step per call of :func:`train_step`; a batch is a
dict of tensors on the model's device (``x0``, ``x1``, ``xt``, ``t`` and,
for flow distillation, ``f0x``, ``f1x``). :func:`make_loss_fn` has the
recipes of the DAT family (the flagship and DAT-TPU: ``dat_loss``), of
IFRNet (``ifrnet_loss``), of DCNDAT (``dcndat_loss``), of DCNTrans
(``dcntrans_loss``), of GMTrans (``gmtrans_loss``) and of MADAT (``madat_loss``);
:func:`make_distill_loss_fn` adds the teacher
term to the DAT family's. The log keys are JAX's. ``model`` may be wrapped in
``DistributedDataParallel`` (:mod:`..parallel.ddp`): the loss calls the
wrapper, which averages the gradients over the processes.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import Config
from ..models.dat import CoarseToFineDAT, dat_loss
from ..models.dcndat import DCNDAT, dcndat_loss
from ..models.dcntrans import DCNTrans, dcntrans_loss
from ..models.gmtrans import GMTrans, gmtrans_loss
from ..models.ifrnet import IFRNet, ifrnet_loss
from ..models.madat import MADAT, madat_loss
from ..ops import charbonnier_l1
from .state import TrainState

LossFn = Callable[[dict], "tuple[torch.Tensor, dict]"]


def _unwrapped(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel`` wrapper, or ``model``."""
    return getattr(model, "module", model)


def make_loss_fn(model: torch.nn.Module, cfg: Config) -> LossFn:
    """``loss_fn(batch) -> (loss, log)`` of the model's own recipe. For
    IFRNet, DCNDAT and DCNTrans the geometry loss encodes the
    mean-normalised ground truth with the model's own encoder; IFRNet reads ``distill_lambda:
    null`` as 0, DCNDAT leaves a ``null`` lambda's term out (as JAX's
    ``train/step.py:106-116`` do)."""
    inner = _unwrapped(model)
    if isinstance(inner, CoarseToFineDAT):

        def loss_fn(batch):
            pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
            return dat_loss(pred, inter, batch, cfg.distill_lambda)

        return loss_fn

    if isinstance(inner, IFRNet):
        distill_lambda = cfg.distill_lambda if cfg.distill_lambda is not None else 0.0

        def loss_fn(batch):
            pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
            gt_feats = inner.encode(batch["xt"] - inter["mean"])
            return ifrnet_loss(pred, inter, batch, gt_feats, geo_lambda=cfg.geo_lambda,
                               distill_lambda=distill_lambda)

        return loss_fn

    if isinstance(inner, DCNDAT):

        def loss_fn(batch):
            pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
            gt_feats = inner.encode(batch["xt"] - inter["mean"])
            return dcndat_loss(pred, inter, batch, gt_feats, geo_lambda=cfg.geo_lambda,
                               distill_lambda=cfg.distill_lambda)

        return loss_fn

    if isinstance(inner, DCNTrans):

        def loss_fn(batch):
            pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
            gt_feats = inner.encode(batch["xt"] - inter["mean"])
            return dcntrans_loss(pred, inter, batch, gt_feats)

        return loss_fn

    if isinstance(inner, GMTrans):

        def loss_fn(batch):
            pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
            return gmtrans_loss(pred, inter, batch)

        return loss_fn

    if isinstance(inner, MADAT):

        def loss_fn(batch):
            pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
            return madat_loss(pred, inter, batch)

        return loss_fn

    raise ValueError(f"no loss ported for model {type(inner).__name__}")


def make_distill_loss_fn(model: torch.nn.Module, teacher: torch.nn.Module, cfg: Config,
                         distill_w: float) -> LossFn:
    """The model's recipe plus output-space teacher distillation,
    ``distill_w * Charbonnier(pred - pred_teacher)``. The teacher is frozen:
    it runs its serving forward under ``torch.no_grad``. The student is
    of the DAT family (the flagship or DAT-TPU), as in JAX."""
    if not isinstance(_unwrapped(model), CoarseToFineDAT):
        raise ValueError(f"no distillation recipe for model {type(model).__name__}")

    def loss_fn(batch):
        pred, inter = model(batch["x0"], batch["x1"], batch["t"], train=True)
        total, log = dat_loss(pred, inter, batch, cfg.distill_lambda)
        with torch.no_grad():
            t_pred = teacher(batch["x0"], batch["x1"], batch["t"])
        t_loss = distill_w * charbonnier_l1(pred - t_pred)
        total = total + t_loss
        log = dict(log)
        log["teacher_loss"] = t_loss
        log["total_loss"] = total
        return total, log

    return loss_fn


def train_step(state: TrainState, loss_fn: LossFn, batch: dict) -> dict:
    """Loss, backward and one AdamW update of ``state`` (in place).
    Returns the log with every value detached (still on the device, so a
    step does not wait for the card)."""
    state.model.train()
    total, log = loss_fn(batch)
    total.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in log.items()}
