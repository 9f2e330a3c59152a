"""Model registry (counterpart of ``videoframeinterpolation_tpu/models/__init__.py``).

Only the flagship is ported so far. ``compute_dtype`` maps as in the JAX
registry (``videoframeinterpolation_tpu/models/__init__.py:32-36``).
"""

from __future__ import annotations

import torch

from ..config import Config
from .base import multi_t_apply
from .dat import DATwConstantnC, dat_loss


def _dat(c: Config, dtype: torch.dtype) -> DATwConstantnC:
    so = c.shared_offsets
    return DATwConstantnC(
        nf=c.nf, enc_res_blocks=c.enc_res_blocks, dec_res_blocks=c.dec_res_blocks,
        mlp_ratio=c.mlp_ratio, window_sampling=c.window_sampling,
        shared_offsets=tuple(so) if isinstance(so, (list, tuple)) else so,
        n_samples=tuple(c.dat_samples), attn_strides=tuple(c.dat_attn_stride),
        movement_nf=tuple(c.dat_movement_nf) if c.dat_movement_nf else None,
        ref_offset_units=c.dat_ref_offset_units, compute_dtype=dtype)


MODEL_REGISTRY = {"DATwConstantnC": _dat, "DATwConstantnCv1": _dat}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: Config) -> torch.dtype:
    """``cfg.compute_dtype`` as a torch dtype; an unknown name raises."""
    try:
        return DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                         f"expected one of {sorted(DTYPES)}") from None


def create_model(cfg: Config, params_dtype: torch.dtype | None = None) -> DATwConstantnC:
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


__all__ = ["DATwConstantnC", "compute_dtype", "create_model", "dat_loss", "multi_t_apply",
           "MODEL_REGISTRY"]
