"""Learning-rate schedule (counterpart of ``videoframeinterpolation_tpu/train/schedule.py``).

Linear warmup over ``warmup_steps``, cosine from ``start_lr`` to ``end_lr``
at ``last_decay_iter``, constant ``end_lr`` afterwards. Computed on the host
in float32, step by step as the JAX function computes it (within one
float32 ulp of it), since the JAX optimizer multiplies its float32 value
into the update.
``cosine_annealing_restarts`` is not ported: no recipe of the port uses it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

WARMUP_STEPS = 2000  # reference default (utils/scheduler.py:10)


def warmup_cosine_lr(step, start_lr: float, end_lr: float, last_decay_iter: int,
                     warmup_steps: int = WARMUP_STEPS) -> np.float32:
    f32 = np.float32
    step = f32(step)
    if step < warmup_steps:
        return f32(start_lr) * step / f32(warmup_steps)
    if step <= last_decay_iter:
        arg = (step - f32(warmup_steps)) / f32(last_decay_iter - warmup_steps) * f32(np.pi)
        # float32 cosine, correctly rounded; XLA's own may differ by 1 ulp.
        ratio = f32(0.5) * (f32(1.0) + f32(np.cos(np.float64(arg))))
        return f32(start_lr - end_lr) * ratio + f32(end_lr)
    return f32(end_lr)


def make_schedule(start_lr: float, end_lr: float, last_decay_iter: int,
                  warmup_steps: int = WARMUP_STEPS) -> Callable[[int], np.float32]:
    def schedule(step):
        return warmup_cosine_lr(step, start_lr, end_lr, last_decay_iter, warmup_steps)

    return schedule
