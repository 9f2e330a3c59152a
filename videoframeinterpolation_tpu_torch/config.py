"""Typed experiment configuration (counterpart of ``videoframeinterpolation_tpu/config``).

:class:`Config` has every field of the JAX ``Config``, with its names and
defaults, and its rules: ``log_dir`` defaults to ``exps/<exp_name>``, a
scalar ``val_datasets`` becomes a tuple, and ``teacher_overrides`` without
``teacher_ckpt`` raises. Unlike the JAX ``Config`` it is frozen: a changed
copy is made with ``dataclasses.replace``. :meth:`Config.from_yaml` and
:meth:`Config.save_yaml` read and write the repository's YAML files through
:mod:`.utils.yaml_subset` (the card's machine has no ``yaml``); unknown
keys raise, as in JAX. Model options the port cannot build raise where the
model is built (``models.create_model``, ``nn/deformable_attn.py``), not
here.

The presets are the three configurations whose checkpoints the repository
ships, written out in Python (a test holds each against the JAX ``Config``
loaded from its YAML); :data:`PRESETS` names each with its checkpoint.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, NamedTuple, Optional, Sequence, Union

from .utils import yaml_subset

REPO_ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Config:
    # Experiment identity
    exp_name: str = "debug"
    log_dir: str = ""          # derived: exps/<exp_name> when empty
    seed: int = 42

    # Model
    model_name: str = "DATwConstantnCv1"
    nf: int = 72
    enc_res_blocks: int = 5
    dec_res_blocks: int = 10
    mlp_ratio: float = 2.0

    # Losses
    distill_lambda: Optional[float] = 0.01
    geo_lambda: float = 0.01
    # Teacher distillation: a checkpoint of the teacher (a flax msgpack
    # TrainState file, or a port experiment's checkpoint named without its
    # suffix) and the config overrides that build the teacher from this
    # config; the student's loss gains distill_teacher_w * Charbonnier(pred
    # - pred_teacher).
    teacher_ckpt: Optional[str] = None
    teacher_overrides: Optional[dict] = None
    distill_teacher_w: float = 0.5

    # Model-family specific (archive models)
    m2m_branch: int = 5
    channels: Sequence[int] = (16, 32, 64)
    depths: Sequence[int] = (3, 3, 3)
    load_gmflow: Optional[str] = None
    # DAT window geometry and the flagship's variants
    radii: Sequence[int] = (2, 2, 3)
    offset_sets: Optional[Sequence] = None
    n_offset_groups: Sequence[int] = (0, 0, 0)
    window_sampling: bool = False
    shared_offsets: Union[bool, Sequence[bool]] = False
    dat_samples: Sequence[int] = (8, 16, 32)
    dat_attn_stride: Sequence[int] = (1, 1, 1)
    dat_movement_nf: Optional[Sequence[int]] = None
    dat_ref_offset_units: bool = False

    # Data
    data_name: str = "Vimeo90KwFlow"
    root: str = "datasets/vimeo_triplet"
    flow_dir: str = "flow"
    distill_bwd: bool = True
    crop_h: int = 256
    crop_w: int = 256

    # Training
    num_epochs: int = 2000
    batch_size: int = 12            # per process (per card)
    num_workers: int = 8

    # Optimizer: AdamW, warmup then cosine start_lr -> end_lr; grad_clip
    # clips the global norm of the gradient first. resume_epoch and
    # last_lr_decay_epoch are read by nothing (the reference's configs have
    # them).
    start_lr: float = 2.0e-4
    end_lr: float = 1.0e-5
    weight_decay: float = 1.0e-4
    last_lr_decay_iter: int = 600_000
    warmup_steps: int = 2000
    grad_clip: Optional[float] = None
    resume_epoch: int = 0
    last_lr_decay_epoch: Optional[int] = None

    # Validation (the benchmark roots are relative to the working directory)
    valid_freq_epoch: int = 1
    val_datasets: Sequence[str] = ("vimeo90k",)
    save_best_benchmark: str = "vimeo90k"
    ucf101_root: str = "datasets/UCF-101/test"
    snu_root: str = "datasets/SNU-FILM"

    # Logging / checkpoint cadence
    img_summary_freq: int = 1000
    metric_summary_freq: int = 100
    save_latest_freq: int = 2000
    save_every_freq_epoch: int = 25

    compute_dtype: str = "bfloat16"   # "bfloat16" | "float32"
    data_axis: str = "data"           # the JAX mesh's axis name (unused by the port)
    resume: Optional[str] = None

    def __post_init__(self):
        def put(name, value):
            object.__setattr__(self, name, value)

        if not self.log_dir:
            put("log_dir", str(Path("exps") / self.exp_name))
        if isinstance(self.val_datasets, str):
            put("val_datasets", (self.val_datasets,))
        for name in ("val_datasets", "channels", "depths"):
            if isinstance(getattr(self, name), list):
                put(name, tuple(getattr(self, name)))
        if self.teacher_overrides and not self.teacher_ckpt:
            raise ValueError(
                "teacher_overrides is set but teacher_ckpt is not: this config declares "
                "teacher distillation, so train the teacher first (two-stage recipe in "
                "configs/DAT_fast_distill.yaml) and set teacher_ckpt, or remove "
                "teacher_overrides for a plain run")

    @classmethod
    def from_yaml(cls, path: str | Path, **overrides: Any) -> "Config":
        """The config a YAML file names, with ``overrides`` on top; unknown
        keys raise."""
        raw = yaml_subset.load(path) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: a config file holds a map of fields")
        raw.update(overrides)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        return cls(**raw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_yaml(self, path: str | Path) -> None:
        Path(path).write_text(yaml_subset.dumps(self.to_dict()))


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

# configs/DAT_fast_distill.yaml, with the committed teacher as its
# teacher_ckpt, and its teacher_overrides applied: the distillation teacher
# (shared offsets, 8/16/8 samples).
DAT_fast_teacher = dataclasses.replace(
    DAT_fast, dat_samples=(8, 16, 8), distill_teacher_w=1.0,
    teacher_ckpt="configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt",
    teacher_overrides={"dat_samples": [8, 16, 8]})


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
