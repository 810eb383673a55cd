"""One process a card: the rank and world size of a multi-card run.

Port of ``initialize_distributed`` and ``process_shard`` of
``followyourclick_tpu/parallel/mesh.py``. The JAX package shards the prompt
list over ``jax.process_index``; here each process of a ``torchrun``-style
launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` in the environment) drives one card and takes its slice of
the work list. Unset, it is rank 0 of 1. The GSPMD mesh itself is not
ported (one process a card needs none); the mesh's ``data`` axis is
``parallel/data_parallel.py``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout: float = 600.0) -> None:
    """Join the process group of a multi-process launch.

    Without ``init_method`` this reads a ``torchrun`` environment and is a
    no-op for a single process (``WORLD_SIZE`` ≤ 1). With it (``file://``
    or ``tcp://host:port``) the group is joined whatever the world size,
    ``rank`` and ``world_size`` taken from the arguments or ``RANK`` /
    ``WORLD_SIZE``. ``backend`` defaults to NCCL on a machine with a card
    and gloo without; NCCL where it is missing raises, it never becomes
    gloo. On NCCL each process selects its card (``LOCAL_RANK``, else the
    rank). A no-op when the group exists already."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", "1"))
                  if world_size is None else world_size)
    if init_method is None:
        if world_size <= 1:
            return
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("NCCL asked for, but this machine has no "
                               "card or no NCCL")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def rank_world(group=None) -> tuple[int, int]:
    """``(rank, world size)`` of this process in ``group`` (the default
    group when None); outside a group, ``RANK`` / ``WORLD_SIZE`` or rank 0
    of 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return (int(os.environ.get("RANK", "0")),
            int(os.environ.get("WORLD_SIZE", "1")))


def process_shard(num_items: int) -> range:
    """This process's contiguous slice of ``num_items`` work items
    (``DistributedSampler`` order without padding, as the JAX package)."""
    rank, world = rank_world()
    per = (num_items + world - 1) // world
    return range(rank * per, min((rank + 1) * per, num_items))
