"""One process a card: the rank and world size of a multi-card run.

Port of ``initialize_distributed`` and ``process_shard`` of
``followyourclick_tpu/parallel/mesh.py``. The JAX package shards the prompt
list over ``jax.process_index``; here each process of a ``torchrun``-style
launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` in the environment) drives one card and takes its slice of
the work list. Unset, it is rank 0 of 1.

:func:`create_mesh` is the counterpart of JAX's ``create_mesh``: a
``(data, model)`` grid over the ranks of a process group, ``model``
innermost, with one ``torch.distributed`` group along each axis. The
``data`` axis shards the batch (``parallel/data_parallel.py``), the
``model`` axis the attention and feed-forward weights
(``parallel/sharding.py``, ``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a ``(data, model)`` grid of ranks: the group
    along each axis (None where the axis has one rank: no collective;
    with one model rank the data axis is the whole group), this rank's
    index on it and the global ranks it holds."""

    shape: dict
    data_group: object
    model_group: object
    data_rank: int
    model_rank: int
    data_ranks: tuple
    model_ranks: tuple
    group: object = None

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]


def create_mesh(data: int = -1, model: int = 1, group=None) -> Mesh:
    """The ``(data, model)`` grid over the ranks of ``group``: global rank
    ``r`` (its index in the group) at data index ``r // model`` and model
    index ``r % model``, so ``model`` is innermost, as in JAX.
    ``data=-1`` takes the ranks that remain. Every rank of ``group`` must
    call this together (it makes the axis groups with
    ``torch.distributed.new_group``). ``group=None`` is one process: the
    grid ``{'data': 1, 'model': 1}`` and no collective. A data-parallel
    run is ``create_mesh(world, 1, group)``: its data axis is ``group``
    itself, so a group of one still runs its collectives."""
    if group is None:
        if data not in (-1, 1) or model != 1:
            raise ValueError(f"a mesh of data={data}, model={model} needs "
                             "a process group")
        return Mesh({"data": 1, "model": 1}, None, None, 0, 0, (0,), (0,))
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks do not divide into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the group has {n}")
    me = dist.get_rank(group)
    grid = [[ranks[i * model + j] for j in range(model)]
            for i in range(data)]
    model_group = data_group = None
    # every rank makes every group, in the same order
    for i in range(data):
        g = dist.new_group(grid[i]) if model > 1 else None
        if i == me // model:
            model_group = g
    for j in range(model):
        if model == 1:
            g = group
        else:
            g = dist.new_group([grid[i][j] for i in range(data)]) \
                if data > 1 else None
        if j == me % model:
            data_group = g
    return Mesh({"data": data, "model": model}, data_group, model_group,
                me // model, me % model,
                tuple(grid[i][me % model] for i in range(data)),
                tuple(grid[me // model]), group)
