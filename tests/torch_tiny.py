"""A small DAT on both sides, shared by the port's CPU tests (a helper module, not a test).

The JAX tools score a checkpoint file, and the JAX package has no
``--enc_res_blocks`` flag in them, so the small model keeps the JAX
``Config``'s five encoder blocks and narrows the rest: nf 16, one decoder
block, shared offsets, samples 4/4/2. Its parameters are the port's
initialisation plus seeded noise of scale 0.1, so that offsets, residuals
and flows are not zero and the frame has contrast: on a low-contrast frame
(std 0.05, noise of 0.05) the fp32 SSIM of the two frameworks differs by up
to 3.3e-5 on the same inputs, as the variance terms cancel against the
constant C2 in different summation orders (3e-6 at noise 0.1). The JAX
side reads the same parameters from the checkpoint the port writes
(``write_flax_state``), as the JAX tools read it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from videoframeinterpolation_tpu_torch.config import DAT_fast
from videoframeinterpolation_tpu_torch.models import create_model
from videoframeinterpolation_tpu_torch.train import create_train_state, state_to_flax
from videoframeinterpolation_tpu_torch.train.checkpoint import write_flax_state

TINY = dataclasses.replace(DAT_fast, nf=16, dec_res_blocks=1, shared_offsets=True,
                           dat_samples=(4, 4, 2), compute_dtype="float32")
# The same with one encoder block, where no JAX tool reads the checkpoint
# (it compiles faster).
TINY_ENC1 = dataclasses.replace(TINY, enc_res_blocks=1)
# The JAX tools' flags for TINY.
TINY_FLAGS = ["--nf", "16", "--shared", "--samples", "4,4,2", "--dec_res_blocks", "1"]
TINY_STEP = 7


def write_tiny_checkpoint(path: Path, seed: int = 0, cfg=TINY) -> Path:
    """``cfg``'s TrainState at step ``TINY_STEP``, written as a flax msgpack file."""
    torch.manual_seed(seed)
    model = create_model(cfg, torch.float32)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)))
    state = create_train_state(model, cfg)
    state.step = TINY_STEP
    write_flax_state(path, state_to_flax(state))
    return path


def jax_tiny(ckpt: Path, cfg=TINY):
    """``cfg`` as the JAX tools build it, and its parameters from ``ckpt``:
    ``(model, params, jitted apply)``."""
    import jax
    from flax import serialization as fser

    from videoframeinterpolation_tpu.config import Config
    from videoframeinterpolation_tpu.models import create_model as jax_create_model

    model = jax_create_model(Config(nf=cfg.nf, enc_res_blocks=cfg.enc_res_blocks,
                                    dec_res_blocks=cfg.dec_res_blocks, compute_dtype="float32",
                                    shared_offsets=cfg.shared_offsets,
                                    dat_samples=tuple(cfg.dat_samples)))
    params = fser.msgpack_restore(Path(ckpt).read_bytes())["params"]
    return model, params, jax.jit(model.apply, static_argnames="train")
