"""Model registry (counterpart of ``videoframeinterpolation_tpu/models/__init__.py``).

Only the flagship is ported in this slice, and it serves fp32.
"""

from __future__ import annotations

from ..config import Config
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


def create_model(cfg: Config) -> DATwConstantnC:
    """Build ``cfg``'s model with fp32 parameters and compute.

    ``compute_dtype="bfloat16"`` raises: bf16 compute waits for a later
    slice. ``interpolate.load_model`` serves such configs in float32.
    """
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port serves float32 only "
            "so far; interpolate.load_model serves bf16 configs in float32")
    try:
        build = MODEL_REGISTRY[cfg.model_name]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model_name!r}; ported: "
                         f"{sorted(MODEL_REGISTRY)}") from None
    return build(cfg)


__all__ = ["DATwConstantnC", "create_model", "MODEL_REGISTRY"]
