"""Typed model configuration (counterpart of ``videoframeinterpolation_tpu/config``).

Only the fields the serving path, the evaluation entry point (its dataset
roots) and the quality study's training recipe (``tools/head_to_head.py``)
read are kept, with the JAX defaults. There is
no YAML parser:
configurations are presets written out in Python, and a test holds each
preset against the JAX ``Config`` loaded from its YAML file.
:data:`PRESETS` names each preset with the committed checkpoint it serves.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Union

REPO_ROOT = Path(__file__).resolve().parent.parent


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
    # Training (JAX Config:33,99-110): AdamW over the warmup-cosine schedule
    # (train/state.py, train/schedule.py) and the flow-distillation weight of
    # dat_loss. grad_clip is not ported: anything but None raises.
    start_lr: float = 2.0e-4
    end_lr: float = 1.0e-5
    weight_decay: float = 1.0e-4
    last_lr_decay_iter: int = 600_000
    warmup_steps: int = 2000
    distill_lambda: Optional[float] = 0.01
    grad_clip: Optional[float] = None
    # Data and validation (JAX Config:88,117-123): the benchmark roots the
    # evaluation entry point reads, relative to the working directory.
    root: str = "datasets/vimeo_triplet"
    save_best_benchmark: str = "vimeo90k"
    ucf101_root: str = "datasets/UCF-101/test"
    snu_root: str = "datasets/SNU-FILM"


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

# configs/DAT.yaml: the non-shared flagship (one offset set per group, the
# reference's 8/16/32 samples).
DAT = dataclasses.replace(DAT_fast, shared_offsets=False, dat_samples=(8, 16, 32))

# configs/DAT_fast_distill.yaml with its teacher_overrides applied: the
# distillation teacher (shared offsets, 8/16/8 samples).
DAT_fast_teacher = dataclasses.replace(DAT_fast, dat_samples=(8, 16, 8))


class Preset(NamedTuple):
    config: Config
    ckpt: Path


# name -> the preset and its committed checkpoint (a flax msgpack TrainState).
PRESETS = {
    "DAT_fast": Preset(DAT_fast, REPO_ROOT / "tools" / "quality" / "results" /
                       "DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.best.ckpt"),
    "DAT": Preset(DAT, REPO_ROOT / "tools" / "quality" / "results" /
                  "DATwConstantnCv1_24k.best.ckpt"),
    "DAT_fast_teacher": Preset(DAT_fast_teacher, REPO_ROOT / "configs" / "teachers" /
                               "DATwConstantnCv1_shared_s8-16-8.best.ckpt"),
}
