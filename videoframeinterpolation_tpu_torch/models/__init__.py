"""Model registry (counterpart of ``videoframeinterpolation_tpu/models/__init__.py``).

Only the flagship is ported so far. ``compute_dtype`` maps as in the JAX
registry (``videoframeinterpolation_tpu/models/__init__.py:32-36``).
"""

from __future__ import annotations

import torch

from ..config import Config
from .base import multi_t_apply
from .dat import DATwConstantnC


def _dat(c: Config) -> DATwConstantnC:
    so = c.shared_offsets
    return DATwConstantnC(
        nf=c.nf, enc_res_blocks=c.enc_res_blocks, dec_res_blocks=c.dec_res_blocks,
        mlp_ratio=c.mlp_ratio, window_sampling=c.window_sampling,
        shared_offsets=tuple(so) if isinstance(so, (list, tuple)) else so,
        n_samples=tuple(c.dat_samples), attn_strides=tuple(c.dat_attn_stride),
        movement_nf=tuple(c.dat_movement_nf) if c.dat_movement_nf else None,
        ref_offset_units=c.dat_ref_offset_units)


MODEL_REGISTRY = {"DATwConstantnC": _dat, "DATwConstantnCv1": _dat}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def create_model(cfg: Config) -> DATwConstantnC:
    """Build ``cfg``'s model with its parameters in ``cfg.compute_dtype``.

    The model computes in the dtype of its parameters. Flax keeps fp32
    parameters and casts each kernel and bias to the compute dtype at every
    call; rounding them once here gives the same values.
    """
    try:
        dtype = DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                         f"expected one of {sorted(DTYPES)}") from None
    try:
        build = MODEL_REGISTRY[cfg.model_name]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model_name!r}; ported: "
                         f"{sorted(MODEL_REGISTRY)}") from None
    return build(cfg).to(dtype)


__all__ = ["DATwConstantnC", "create_model", "multi_t_apply", "MODEL_REGISTRY"]
