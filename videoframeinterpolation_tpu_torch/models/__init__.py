"""Model registry (counterpart of ``videoframeinterpolation_tpu/models/__init__.py``).

Ported: the flagship ``DATwConstantnC`` (alias ``DATwConstantnCv1``),
``IFRNet``, ``DATwConstantnCTPU``, ``DCNDAT`` (alias ``DCNDATv1``) and
``DCNTrans`` (alias ``DCNTransv1``), each built from a ``Config`` as the
JAX registry builds it (``videoframeinterpolation_tpu/models/__init__.py:39-102``).
``DCNTransFwarp`` (alias ``DCNTransv2``) raises, as it needs the forward
warp; the other archive families are not ported yet. ``compute_dtype``
maps as in the JAX registry
(``videoframeinterpolation_tpu/models/__init__.py:32-36``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from .base import multi_t_apply
from .dat import CoarseToFineDAT, DATwConstantnC, dat_loss
from .dat_tpu import DATwConstantnCTPU, dat_tpu_loss
from .dcndat import DCNDAT, dcndat_loss
from .dcntrans import DCNTrans, dcntrans_loss
from .ifrnet import IFRNet, ifrnet_loss


def _dat(c: Config, dtype: torch.dtype) -> DATwConstantnC:
    so = c.shared_offsets
    return DATwConstantnC(
        nf=c.nf, enc_res_blocks=c.enc_res_blocks, dec_res_blocks=c.dec_res_blocks,
        mlp_ratio=c.mlp_ratio, window_sampling=c.window_sampling,
        shared_offsets=tuple(so) if isinstance(so, (list, tuple)) else so,
        n_samples=tuple(c.dat_samples), attn_strides=tuple(c.dat_attn_stride),
        movement_nf=tuple(c.dat_movement_nf) if c.dat_movement_nf else None,
        ref_offset_units=c.dat_ref_offset_units, compute_dtype=dtype)


def _dat_tpu(c: Config, dtype: torch.dtype) -> DATwConstantnCTPU:
    return DATwConstantnCTPU(
        nf=c.nf, enc_res_blocks=c.enc_res_blocks, dec_res_blocks=c.dec_res_blocks,
        mlp_ratio=c.mlp_ratio, radii=tuple(c.radii),
        offset_sets=(tuple(tuple(o) for o in c.offset_sets)
                     if c.offset_sets is not None else None),
        n_offset_groups=tuple(c.n_offset_groups), compute_dtype=dtype)


def _dcndat(c: Config, dtype: torch.dtype) -> DCNDAT:
    return DCNDAT(nf=c.nf, enc_res_blocks=c.enc_res_blocks, dec_res_blocks=c.dec_res_blocks,
                  mlp_ratio=c.mlp_ratio, compute_dtype=dtype)


def _dcntrans(c: Config, dtype: torch.dtype) -> DCNTrans:
    return DCNTrans(nf=c.nf, enc_res_blocks=c.enc_res_blocks, dec_res_blocks=c.dec_res_blocks,
                    mlp_ratio=c.mlp_ratio, compute_dtype=dtype)


def _dcntrans_fwarp(c: Config, dtype: torch.dtype) -> nn.Module:
    raise ValueError(f"{c.model_name} (DCNTrans v2) builds its query with the forward warp, "
                     "which the port does not have yet (ROADMAP.md, queue 1 item 9c); "
                     "DCNTrans v1 is model_name DCNTrans or DCNTransv1")


def _ifrnet(c: Config, dtype: torch.dtype) -> IFRNet:
    # As in JAX, the widths are IFRNet's own, not the config's ``channels``.
    return IFRNet(compute_dtype=dtype)


MODEL_REGISTRY = {"DATwConstantnC": _dat, "DATwConstantnCv1": _dat,
                  "DATwConstantnCTPU": _dat_tpu, "IFRNet": _ifrnet, "DCNDAT": _dcndat,
                  "DCNDATv1": _dcndat, "DCNTrans": _dcntrans, "DCNTransv1": _dcntrans,
                  "DCNTransFwarp": _dcntrans_fwarp, "DCNTransv2": _dcntrans_fwarp}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: Config) -> torch.dtype:
    """``cfg.compute_dtype`` as a torch dtype; an unknown name raises."""
    try:
        return DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                         f"expected one of {sorted(DTYPES)}") from None


def create_model(cfg: Config, params_dtype: torch.dtype | None = None) -> nn.Module:
    """Build ``cfg``'s model, computing in ``cfg.compute_dtype``, with its
    parameters in ``params_dtype`` (default: the compute dtype).

    Flax keeps fp32 parameters and casts each kernel and bias to the
    compute dtype at every call. Training does the same (``params_dtype``
    fp32: master weights, the gradient flowing back through the cast);
    serving rounds them once here, which gives the same values.
    """
    dtype = compute_dtype(cfg)
    try:
        build = MODEL_REGISTRY[cfg.model_name]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model_name!r}; ported: "
                         f"{sorted(MODEL_REGISTRY)}") from None
    return build(cfg, dtype).to(params_dtype or dtype)


__all__ = ["CoarseToFineDAT", "DATwConstantnC", "DATwConstantnCTPU", "DCNDAT", "DCNTrans",
           "IFRNet", "compute_dtype", "create_model", "dat_loss", "dat_tpu_loss", "dcndat_loss",
           "dcntrans_loss", "ifrnet_loss", "multi_t_apply", "MODEL_REGISTRY"]
