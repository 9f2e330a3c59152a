"""Typed model configuration (counterpart of ``videoframeinterpolation_tpu/config``).

Only the fields the serving path reads are kept. There is no YAML parser:
configurations are presets written out in Python, and a test holds each
preset against the JAX ``Config`` loaded from its YAML file.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 42
    model_name: str = "DATwConstantnCv1"
    nf: int = 72
    enc_res_blocks: int = 5
    dec_res_blocks: int = 10
    mlp_ratio: float = 2.0
    window_sampling: bool = False
    shared_offsets: Union[bool, Sequence[bool]] = False
    dat_samples: Sequence[int] = (8, 16, 32)
    dat_attn_stride: Sequence[int] = (1, 1, 1)
    dat_movement_nf: Optional[Sequence[int]] = None
    dat_ref_offset_units: bool = False
    compute_dtype: str = "bfloat16"   # "bfloat16" | "float32"


# configs/DAT_fast.yaml: the shipped flagship (shared offsets, 8/8/2 samples).
DAT_fast = Config(
    seed=42,
    model_name="DATwConstantnCv1",
    nf=72,
    enc_res_blocks=5,
    dec_res_blocks=10,
    mlp_ratio=2.0,
    shared_offsets=True,
    dat_samples=(8, 8, 2),
    compute_dtype="bfloat16",
)
