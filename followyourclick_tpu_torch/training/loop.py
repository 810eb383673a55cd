"""The training loop: data → train steps → checkpoints, with auto-resume.

Port of ``followyourclick_tpu/training/loop.py``: ``LoopConfig``, the
temporal multi-scale frame crop (``np.random.RandomState(1234 +
start_step)``), the ``log_every`` line, checkpoints every
``checkpointing_steps`` with keep-N and resume from the latest, and the
``validation_steps`` / ``validation_steps_tuple`` hook.

Checkpoints are the port's own files in place of Orbax's:
``output_dir/checkpoints/<step>/state.pt``, one ``torch.save`` of the JAX
payload's keys (``trainable``, ``frozen``, ``opt_state``, ``step``; the
full-tree state's ``params``, ``opt_state``, ``step``), written to a
temporary name and moved into place. A restore copies the file's tensors
into the state's own, in place.

Step randomness: step ``n`` draws from a generator on the state's device
seeded with ``seed`` and ``n`` (:func:`step_generator`), so a resumed run
takes the draws the uninterrupted run took at the same steps and, on the
same device, reproduces its state. (The JAX loop restarts its key from
``rng`` on resume, so there a resumed run draws anew.)

Over ranks (``mesh=``, a ``parallel/mesh.create_mesh`` grid; a
data-parallel run is ``create_mesh(world, 1, group)``): each rank's
``data_iter`` yields its data rank's rows of the global batch and
``step_fn`` takes the step over the mesh (e.g.
``train_step_partitioned(..., mesh=mesh)``). Every rank seeds the frame
crop and the step generators alike, so all crop the same frames and draw
the global batch's draws. Rank 0 alone prints, logs, validates and writes
the checkpoints, each write between two barriers; every rank restores
from the same file.

With model ranks (the state's split leaves are the model rank's
slices, ``training/step.py``): every rank gathers the full tensors of
the state over its model ranks (``parallel/sharding.gather_tensors``)
and rank 0 writes them, between barriers over the whole grid; a restore
keeps each rank's slice of the file's full tensors. So a checkpoint is
the same file whatever the grid: one written over model ranks loads in
one process, and the other way round. ``validation_fn`` gets the full
tensors too, gathered by every rank, as JAX's loop passes the logical
params.

Under ``utils/profiling.tracing`` each iteration, ``next(data_iter)``
included, is a span ``fyc.train.step``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from followyourclick_tpu_torch.parallel.data_parallel import (
    barrier,
    group_rank_world,
)
from followyourclick_tpu_torch.utils.backend_flags import checked_precision
from followyourclick_tpu_torch.utils.profiling import span

STATE_FILE = "state.pt"


@dataclasses.dataclass
class LoopConfig:
    output_dir: str = "outputs/train"
    max_train_steps: int = 50_000
    checkpointing_steps: int = 2_000
    log_every: int = 50
    need_resume: bool = True
    keep_checkpoints: int = 5
    # temporal multi-scale training: a random frame-count crop a step
    temporal_multi_scale: bool = True
    min_frames: int = 8
    # validation sampling cadence (0 = no periodic validation), plus extra
    # one-off steps
    validation_steps: int = 0
    validation_steps_tuple: tuple = ()


class CheckpointManager:
    """Step-numbered checkpoint directories under ``directory``, keeping
    the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: dict) -> None:
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(d, STATE_FILE))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: int) -> dict:
        return torch.load(os.path.join(self.directory, str(step),
                                       STATE_FILE),
                          map_location="cpu", weights_only=True)


def make_checkpoint_manager(directory: str,
                            keep: int = 5) -> CheckpointManager:
    return CheckpointManager(directory, keep)


def _state_payload(state) -> dict:
    """The checkpoint payload of either state layout."""
    if hasattr(state, "trainable"):
        return {"trainable": state.trainable, "frozen": state.frozen,
                "opt_state": state.opt_state, "step": state.step}
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step}


def _map_tensors(payload, fn):
    """``payload`` with ``fn(tensors)`` applied to each dict of named
    leaves (the parameter dicts and the moments)."""
    out = {}
    for key, value in payload.items():
        if key == "opt_state":
            value = {k: fn(v) if k in ("mu", "nu") else v
                     for k, v in value.items()}
        elif isinstance(value, dict):
            value = fn(value)
        out[key] = value
    return out


def _split(state, mesh) -> dict:
    """Name → ``(dim, halves)`` of the state's split leaves ({} off a mesh
    with model ranks)."""
    if mesh is None or mesh.model_size == 1:
        return {}
    return state.tx.split


def _full_params(state, mesh) -> dict:
    """``state.params`` with each split leaf gathered over the model
    ranks (every rank calls it)."""
    from followyourclick_tpu_torch.parallel.sharding import gather_tensors

    split = _split(state, mesh)
    return gather_tensors(state.params, split, mesh) if split \
        else state.params


def save_checkpoint(manager: CheckpointManager, step: int, state,
                    mesh=None) -> None:
    """Write ``state`` at ``step``; over a ``mesh``, rank 0 writes
    between two barriers that span the grid (the other data ranks' states
    are equal to its own), the full tensors every rank gathered over its
    model ranks."""
    from followyourclick_tpu_torch.parallel.sharding import gather_tensors

    group = None if mesh is None else mesh.group
    barrier(group)
    payload = _state_payload(state)
    split = _split(state, mesh)
    if split:
        payload = _map_tensors(payload, lambda t: gather_tensors(
            t, split, mesh))
    if group_rank_world(group)[0] == 0:
        manager.save(step, payload)
    barrier(group)


def _copy_into(target, source):
    """``source``'s values into ``target`` (nested dicts of tensors), in
    place; returns what to store where a leaf is no tensor."""
    if isinstance(target, dict):
        if set(target) != set(source):
            raise ValueError("checkpoint keys differ from the state's")
        for k in target:
            target[k] = _copy_into(target[k], source[k])
        return target
    if isinstance(target, torch.Tensor):
        return target.copy_(source)
    return source


def restore_checkpoint(manager: CheckpointManager, state, mesh=None):
    """Resume from the latest checkpoint if there is one (auto-resume);
    returns ``(state, step)``. On a ``mesh`` each split leaf takes this
    model rank's slice of the file's full tensor."""
    from followyourclick_tpu_torch.parallel.sharding import shard_tensors

    latest = manager.latest_step()
    if latest is None:
        return state, 0
    payload = manager.restore(latest)
    split = _split(state, mesh)
    if split:
        payload = _map_tensors(payload, lambda t: shard_tensors(
            t, split, mesh))
    with torch.no_grad():
        for key, value in _state_payload(state).items():
            setattr(state, key, _copy_into(value, payload[key]))
    return state, int(latest)


def _subsample_frames(batch, rng: np.random.RandomState, min_frames: int):
    """Temporal multi-scale: a random frame-count crop for this step."""
    f = batch.latents.shape[1]
    if f <= min_frames:
        return batch
    nf = int(rng.choice([min_frames, (min_frames + f) // 2, f]))
    if nf == f:
        return batch
    start = rng.randint(0, f - nf + 1)
    return dataclasses.replace(batch,
                               latents=batch.latents[:, start:start + nf])


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator of step ``step`` (0-based) of a run seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


def _device(state) -> torch.device:
    tensors = state.trainable if hasattr(state, "trainable") \
        else state.params
    return next(iter(tensors.values())).device


@checked_precision()
def train_loop(state, data_iter: Iterator, step_fn: Callable,
               cfg: LoopConfig, seed: int = 0,
               on_log: Optional[Callable] = None,
               validation_fn: Optional[Callable] = None, mesh=None):
    """Run the loop; returns the final state. ``step_fn(state, batch,
    generator)`` returns ``(state, metrics)``; ``validation_fn(step,
    params)`` runs at every ``cfg.validation_steps`` interval and at each
    step of ``cfg.validation_steps_tuple``. Over a ``mesh`` (see the
    module docstring; ``data_iter`` yields the data rank's rows)
    ``on_log`` and ``validation_fn`` run on rank 0, with the full params,
    and the other ranks wait for the validation."""
    group = None if mesh is None else mesh.group
    lead = group_rank_world(group)[0] == 0
    manager = make_checkpoint_manager(
        os.path.join(cfg.output_dir, "checkpoints"), cfg.keep_checkpoints)
    start_step = 0
    if cfg.need_resume:
        state, start_step = restore_checkpoint(manager, state, mesh)
        if start_step and lead:
            print(f"[train_loop] resumed from step {start_step}")

    device = _device(state)
    host_rng = np.random.RandomState(1234 + start_step)
    t0 = time.time()
    for step in range(start_step, cfg.max_train_steps):
        with span("fyc.train.step"):
            batch = next(data_iter)
            if cfg.temporal_multi_scale:
                batch = _subsample_frames(batch, host_rng, cfg.min_frames)
            state, metrics = step_fn(state, batch,
                                     step_generator(seed, step, device))

            if (step + 1) % cfg.log_every == 0 and lead:
                loss = float(metrics["loss"])
                dt = (time.time() - t0) / cfg.log_every
                t0 = time.time()
                print(f"step {step + 1}/{cfg.max_train_steps} "
                      f"loss={loss:.4f} {dt * 1e3:.0f} ms/step")
                if on_log is not None:
                    on_log(step + 1, metrics)
            if (step + 1) % cfg.checkpointing_steps == 0:
                save_checkpoint(manager, step + 1, state, mesh)
            if validation_fn is not None and (
                    (cfg.validation_steps
                     and (step + 1) % cfg.validation_steps == 0)
                    or (step + 1) in cfg.validation_steps_tuple):
                params = _full_params(state, mesh)
                if lead:
                    validation_fn(step + 1, params)
                barrier(group)
    return state
