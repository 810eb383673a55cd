"""Data parallelism over ranks: the counterpart of the mesh's ``data`` axis.

The JAX package trains on a ``(data, model)`` mesh with the batch sharded
on ``data`` (``P("data")``); GSPMD then sums the gradients across the
devices inside the jitted step. Here one process drives one card (or, on
the CPU, one ``gloo`` rank): each rank takes its contiguous rows of the
global batch (:func:`shard_rows`), computes its gradients, and
:func:`all_reduce_mean_` averages them before the optimizer sees them, so
every rank takes the same update. ``ops/fused.dp_wrap`` (a shard_map
workaround for GSPMD) has no counterpart.

A ``group`` of None everywhere here means one process: no collective runs.
:func:`launch` starts ``world`` local processes that each join a group and
run one function (the CPU tests, ``entry.dryrun_multichip``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterable, Mapping, Sequence, Union

import torch

Tensors = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def group_rank_world(group) -> tuple[int, int]:
    """``(rank, world)`` in ``group``; ``(0, 1)`` for None."""
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def shard_rows(x, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of ``x`` (a tensor, or a dataclass of
    tensors such as ``TrainBatch`` / ``StepDraws``, each sliced on its
    first axis). Raises unless the rows divide by ``world``, as a JAX
    ``P("data")`` sharding does."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: shard_rows(getattr(x, f.name), rank, world)
            for f in dataclasses.fields(x)})
    if not torch.is_tensor(x):
        raise TypeError(f"cannot shard {type(x).__name__} by rows")
    rows = x.shape[0]
    if rows % world:
        raise ValueError(f"a global batch of {rows} rows does not divide "
                         f"over {world} ranks")
    per = rows // world
    return x[rank * per:(rank + 1) * per]


def _per_dtype_buffer(tensors: Tensors, collective: Callable) -> Tensors:
    """Run ``collective`` on one flat buffer per dtype of ``tensors`` (a
    dict or list) and copy the buffers back into the tensors."""
    groups: dict = {}
    for t in (tensors.values() if isinstance(tensors, Mapping)
              else tensors):
        groups.setdefault(t.dtype, []).append(t)
    for leaves in groups.values():
        flat = torch.cat([t.reshape(-1) for t in leaves])
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in leaves:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return tensors


def all_reduce_mean_(tensors: Tensors, group) -> Tensors:
    """Average ``tensors`` (a dict or list) over the ranks of ``group`` in
    place: one flat buffer per dtype, summed by one collective, divided by
    the world size. Returns ``tensors``; a no-op for ``group=None``."""
    if group is None:
        return tensors
    import torch.distributed as dist

    world = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(world)

    return _per_dtype_buffer(tensors, mean)


def broadcast_(tensors: Tensors, src: int = 0, group=None) -> Tensors:
    """Overwrite ``tensors`` in place with rank ``src``'s, one flat buffer
    per dtype; a no-op for ``group=None``."""
    if group is None:
        return tensors
    import torch.distributed as dist

    return _per_dtype_buffer(tensors, lambda flat: dist.broadcast(
        flat, src=dist.get_global_rank(group, src), group=group))


def barrier(group) -> None:
    """Wait for every rank of ``group``; a no-op for None."""
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def _rank_main(job_path: str, rank: int) -> None:
    """One rank of :func:`launch` (``python -m`` this module): one intra-op
    thread, the group joined, the job's function run and its result saved
    for the parent."""
    import pickle

    import torch.distributed as dist

    from followyourclick_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    initialize_distributed(job["backend"], job["init_method"], rank,
                           job["world"], job["timeout"])
    try:
        result = job["fn"](*job["args"])
        torch.save(result, os.path.join(os.path.dirname(job_path),
                                        f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Iterable = (),
           backend: str = "gloo", timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``world`` new local processes that form one
    group (``dist.group.WORLD`` inside ``fn``), rank ``r`` in process
    ``r``; returns each rank's result, in rank order. Each process is a
    fresh interpreter that imports this module and ``fn``'s, nothing of
    the caller's ``__main__``; ``fn`` and ``args`` must pickle. The
    rendezvous is a ``file://`` store for gloo and ``tcp://127.0.0.1`` on
    a free port for NCCL. A rank that fails, or a run past ``timeout``
    seconds, stops every rank and raises here with the rank's last
    errors."""
    import pickle
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (os.environ.get("PYTHONPATH"), root) if p))
    with tempfile.TemporaryDirectory(prefix="fyc_ranks_") as out_dir:
        init_method = (f"tcp://127.0.0.1:{free_port()}" if backend == "nccl"
                       else "file://" + os.path.join(out_dir, "store"))
        job_path = os.path.join(out_dir, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump({"fn": fn, "args": tuple(args), "world": world,
                         "backend": backend, "init_method": init_method,
                         "timeout": timeout}, f)
        logs = [open(os.path.join(out_dir, f"rank{r}.err"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", __name__, job_path, str(r)], env=env,
            stderr=logs[r]) for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    logs[failed[0]].seek(0)
                    raise RuntimeError(
                        f"rank {failed[0]} of {world} exited with "
                        f"{codes[failed[0]]}:\n"
                        f"{logs[failed[0]].read()[-4000:]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of "
                                       f"{getattr(fn, '__name__', fn)} "
                                       f"ran past {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    import sys

    _rank_main(sys.argv[1], int(sys.argv[2]))
