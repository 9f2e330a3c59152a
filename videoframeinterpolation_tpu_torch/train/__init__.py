"""Training of the port: checkpoints, the optimizer and its schedule, the step."""

from .checkpoint import flax_msgpack_bytes, read_flax_msgpack, read_flax_state, write_flax_state
from .schedule import make_schedule, warmup_cosine_lr
from .state import (AdamW, AdamWState, TrainState, create_optimizer, create_train_state,
                    state_from_flax, state_to_flax)
from .step import make_distill_loss_fn, make_loss_fn, train_step

__all__ = ["AdamW", "AdamWState", "TrainState", "create_optimizer", "create_train_state",
           "flax_msgpack_bytes", "make_distill_loss_fn", "make_loss_fn", "make_schedule",
           "read_flax_msgpack", "read_flax_state", "state_from_flax", "state_to_flax",
           "train_step", "warmup_cosine_lr", "write_flax_state"]
