"""Data parallelism over processes (counterpart of ``videoframeinterpolation_tpu/parallel/mesh.py``).

The JAX trainer shards each global batch of ``batch_size x n_devices``
over a 1-D device mesh. The port runs one process per card, as ``torchrun``
starts them: each process reads its rank and the world size from the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), loads its own shard of every epoch (the loader's
``shard_index`` and ``num_shards``), takes a batch of ``batch_size``, and
wraps the model in ``DistributedDataParallel``, which averages the
gradients over the processes: with equal batches and a loss that is a
mean over items, that is the gradient of the global batch of ``batch_size
x world_size``. NCCL joins the processes on the card, gloo on the CPU.
With a world of one no process group is created and the model is not
wrapped.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class World(NamedTuple):
    rank: int
    size: int
    local_rank: int

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def world_from_env() -> World:
    """Rank, world size and local rank as ``torchrun`` sets them (one
    process and rank 0 where it did not)."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    return World(rank, size, int(os.environ.get("LOCAL_RANK", str(rank))))


def init(device: torch.device, world: World | None = None) -> tuple[World, torch.device]:
    """Join the process group of ``world`` (default: from the environment)
    and return it with this process's device: ``cuda:<local_rank>`` for a
    CUDA ``device``, ``device`` itself on the CPU. A world of one joins
    nothing."""
    world = world or world_from_env()
    if device.type == "cuda":
        device = torch.device("cuda", world.local_rank if world.size > 1 else
                              (device.index or 0))
        torch.cuda.set_device(device)
    if world.size > 1 and not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=world.rank, world_size=world.size)
    return world, device


def wrap(model: torch.nn.Module, world: World, device: torch.device) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` over ``world`` (the model
    itself for a world of one). The flagship has no buffers, and its
    forward leaves no parameter without a gradient, so DDP looks for none."""
    if world.size == 1:
        return model
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None)


def mean_over_world(x: torch.Tensor, world: World) -> torch.Tensor:
    """The mean of ``x`` over the processes (``x`` itself for one)."""
    if world.size == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x / world.size


def shutdown(world: World) -> None:
    if world.size > 1 and dist.is_initialized():
        dist.destroy_process_group()
