"""Data parallelism of the port (``parallel/ddp.py``) on the CPU, over gloo.

Two processes, each with half of a batch, take one training step of a
small DAT through ``DistributedDataParallel``; the updated parameters equal
one process's step on the whole batch within ``DDP_TOL`` relative (L2 over
every parameter): DDP averages the two half-batch gradients, and each loss
is a mean over its items, so the average is the whole batch's gradient up
to the order of the sums.
"""

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.multiprocessing as mp

from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.models import create_model
from videoframeinterpolation_tpu_torch.parallel import ddp
from videoframeinterpolation_tpu_torch.train import create_train_state, make_loss_fn

DDP_TOL = 1e-6
CFG = dataclasses.replace(Config(), nf=16, enc_res_blocks=1, dec_res_blocks=1,
                          shared_offsets=True, dat_samples=(8, 8, 2), compute_dtype="float32",
                          warmup_steps=0)


def _batch(B=4, H=32, W=32):
    rng = np.random.default_rng(0)
    out = {k: rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for k in ("x0", "x1", "xt")}
    out["t"] = np.full((B, 1, 1, 1), 0.5, np.float32)
    for k in ("f0x", "f1x"):
        out[k] = (rng.standard_normal((B, H, W, 2)) * 0.02).astype(np.float32)
    return out


def _step(batch: dict, world: ddp.World) -> tuple[dict, dict]:
    """One step; the gradient it applied and the parameters it left, as numpy."""
    torch.set_num_threads(1)
    world, device = ddp.init(torch.device("cpu"), world)
    torch.manual_seed(0)
    model = create_model(CFG, torch.float32)
    state = create_train_state(model, CFG)
    loss_fn = make_loss_fn(ddp.wrap(model, world, device), CFG)
    total, _ = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    grads = {k: p.grad.numpy().copy() for k, p in state.params.items()}
    state.apply_gradients()
    ddp.shutdown(world)
    return grads, {k: p.detach().numpy().copy() for k, p in state.params.items()}


def _rank(rank: int, port: int, out: dict) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    half = {k: v[2 * rank:2 * rank + 2] for k, v in _batch().items()}
    result = _step(half, ddp.World(rank, 2, rank))
    if rank == 0:
        out["result"] = result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a: dict, b: dict) -> float:
    """``|a - b| / |b|``, L2 over every parameter."""
    diff = np.concatenate([(a[k] - b[k]).ravel() for k in b])
    return float(np.linalg.norm(diff) / np.linalg.norm(np.concatenate([v.ravel()
                                                                       for v in b.values()])))


def test_two_process_step_equals_one_process_step_on_the_whole_batch():
    grads, params = _step(_batch(), ddp.World(0, 1, 0))
    with mp.get_context("spawn").Manager() as manager:
        out = manager.dict()
        mp.start_processes(_rank, args=(_free_port(), out), nprocs=2, join=True,
                           start_method="spawn")
        two_grads, two_params = out["result"]
    assert two_grads.keys() == grads.keys()
    print(f"gradient {_rel(two_grads, grads):.3g}, parameters {_rel(two_params, params):.3g}")
    assert _rel(two_grads, grads) <= DDP_TOL
    assert _rel(two_params, params) <= DDP_TOL


def test_world_from_env_and_a_world_of_one(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert ddp.world_from_env() == ddp.World(0, 1, 0)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert ddp.world_from_env() == ddp.World(3, 4, 1)
    model = torch.nn.Linear(2, 2)
    one = ddp.World(0, 1, 0)
    assert ddp.wrap(model, one, torch.device("cpu")) is model
    x = torch.arange(3.0)
    assert ddp.mean_over_world(x, one) is x
