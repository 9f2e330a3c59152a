"""A small DAT on both sides, and helpers shared by the port's CPU model tests (a helper module, not a test).

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
import os
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


def write_tiny_checkpoint(path: Path, seed: int = 0, cfg=TINY, scale: float = 0.1) -> Path:
    """``cfg``'s TrainState at step ``TINY_STEP``, its parameters the port's
    initialisation plus seeded normal noise of ``scale``, written as a flax
    msgpack file."""
    torch.manual_seed(seed)
    model = create_model(cfg, torch.float32)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, scale, tuple(p.shape)).astype(np.float32)))
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


def jax_init(module, *args, **kwargs):
    """``module``'s flax variables, initialised by a jitted ``init``. The key
    is of the ``unsafe_rbg`` implementation: its random bits compile in a
    third of threefry's time, and the tests read only the spread of the
    draws, not their values."""
    import jax

    return jax.jit(module.init, static_argnames=tuple(kwargs))(
        jax.random.key(0, impl="unsafe_rbg"), *args, **kwargs)


def compile_side_by_side(*calls):
    """``(fn, args)`` pairs jitted and lowered in turn (tracing holds the
    interpreter lock), each compiled in a thread of its own as soon as it
    is lowered (XLA compiles outside the lock, beside the next tracing):
    the compiled calls, each taking arguments of the shapes and types it
    was lowered with."""
    import concurrent.futures

    import jax

    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(jax.jit(fn).lower(*args).compile) for fn, args in calls]
        return [f.result() for f in futures]


def perturbed(tree, seed: int, scale: float = 0.05):
    """``tree`` (flax variables) plus seeded normal noise, as float32 numpy:
    offsets, masks and flows that initialise to zero become non-zero."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, scale, a.shape).astype(np.float32), tree)


def smooth_pair(b: int, h: int, w: int, seed: int):
    """``b`` smooth random textures (bilinear upsampling of coarse noise, one
    value per 8 pixels) and their copies shifted by (1, 2) pixels, float32
    ``(b, h, w, 3)`` each."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((b, 3, h // 8 + 2, w // 8 + 2), dtype=np.float32))
    tex = F.interpolate(coarse, size=(h + 8, w + 8), mode="bilinear", align_corners=True)
    tex = tex.permute(0, 2, 3, 1).numpy()
    return tex[:, 4:4 + h, 4:4 + w].copy(), tex[:, 5:5 + h, 6:6 + w].copy()


def run_in(base: Path, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``base`` as the working directory (the
    entry points read the config's relative roots and ``exps/`` from it)."""
    cwd = os.getcwd()
    os.chdir(base)
    try:
        return fn(*args, **kwargs)
    finally:
        os.chdir(cwd)
