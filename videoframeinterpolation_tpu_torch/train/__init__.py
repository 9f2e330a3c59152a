"""Training of the port: checkpoints, the optimizer and its schedule, the step.

The trainer (:mod:`.trainer`) and its entry point (``python -m
videoframeinterpolation_tpu_torch.train``) are imported where they are used.
"""

from .checkpoint import (CheckpointManager, flax_msgpack_bytes, read_flax_msgpack,
                         read_flax_state, restore_teacher_params, write_flax_state)
from .preemption import PreemptionGuard
from .schedule import make_schedule, warmup_cosine_lr
from .state import (AdamW, AdamWState, TrainState, create_optimizer, create_train_state,
                    state_from_flax, state_to_flax)
from .step import make_distill_loss_fn, make_loss_fn, train_step

__all__ = ["AdamW", "AdamWState", "CheckpointManager", "PreemptionGuard", "TrainState",
           "create_optimizer", "create_train_state", "flax_msgpack_bytes",
           "make_distill_loss_fn", "make_loss_fn", "make_schedule", "read_flax_msgpack",
           "read_flax_state", "restore_teacher_params", "state_from_flax", "state_to_flax",
           "train_step", "warmup_cosine_lr", "write_flax_state"]
