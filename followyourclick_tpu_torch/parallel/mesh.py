"""One process a card: the rank and world size of a multi-card run.

Port of ``initialize_distributed`` and ``process_shard`` of
``followyourclick_tpu/parallel/mesh.py``. The JAX package shards the prompt
list over ``jax.process_index``; here each process of a ``torchrun``-style
launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` in the environment) drives one card and takes its slice of
the work list. Unset, it is rank 0 of 1. The GSPMD mesh itself is not
ported (one process a card needs none).
"""

from __future__ import annotations

import os

import torch


def initialize_distributed() -> None:
    """Join the process group of a multi-process launch (``WORLD_SIZE`` >
    1): NCCL over the cards, gloo without; select this process's card
    (``LOCAL_RANK``). A no-op for a single process."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo")


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("RANK", "0")),
            int(os.environ.get("WORLD_SIZE", "1")))


def process_shard(num_items: int) -> range:
    """This process's contiguous slice of ``num_items`` work items
    (``DistributedSampler`` order without padding, as the JAX package)."""
    rank, world = _rank_world()
    per = (num_items + world - 1) // world
    return range(rank * per, min((rank + 1) * per, num_items))
