"""The rank workers of the data-parallel and sharded-evaluation tests.

Each runs inside a process of ``parallel.data_parallel.launch`` (one
``gloo`` rank, one thread) and imports torch and the port only: no JAX,
no test module with JAX, so a rank starts in a few seconds. Each reads a
job the test saved with ``torch.save`` and returns plain tensors and
numbers, with ``jax_loaded`` so that the test can check the rank stayed
JAX-free.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import sys

import torch
import torch.distributed as dist

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.parallel.data_parallel import shard_rows
from followyourclick_tpu_torch.parallel.mesh import create_mesh, rank_world
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
from followyourclick_tpu_torch.training import loop as tl
from followyourclick_tpu_torch.training import step as ts


def _jax_loaded() -> bool:
    return any(name.split(".")[0] in ("jax", "flax", "followyourclick_tpu")
               for name in sys.modules)


def _models(job):
    unet = UNet3DConditionModel(job["unet_config"])
    unet.load_state_dict(job["unet_state"])
    text = CLIPTextModel(job["text_config"])
    text.load_state_dict(job["text_state"])
    return unet, text.eval()


def _clone(tensors: dict) -> dict:
    return {n: t.detach().clone() for n, t in tensors.items()}


def train_steps(job_path: str) -> dict:
    """``job["partitioned_steps"]`` partitioned steps (``cfg``, frozen
    leaves fp32) and ``job["full_steps"]`` full-tree steps (``full_cfg``)
    over the group, each on this rank's rows of the global batch and
    draws. Ranks other than 0 start from perturbed weights, so the states'
    broadcast is what makes them equal."""
    job = torch.load(job_path, weights_only=False)
    rank, world = rank_world()
    mesh = create_mesh(world, 1, dist.group.WORLD)
    unet, text = _models(job)
    if rank:
        with torch.no_grad():
            for t in unet.parameters():
                t.add_(0.5)
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
    batch = shard_rows(ts.TrainBatch(**job["batch"]), rank, world)
    out = {"rank": rank, "world": world}
    if job["partitioned_steps"]:
        cfg = job["cfg"]
        state = ts.create_partitioned_train_state(
            unet, cfg, frozen_dtype=torch.float32, mesh=mesh)
        out["start"] = _clone(state.params)
        metrics = []
        for draws in job["draws"][:job["partitioned_steps"]]:
            state, m = ts.train_step_partitioned(
                state, batch, None, unet=unet, text_encoder=text,
                sched=sched, cfg=cfg, draws=shard_rows(draws, rank, world),
                mesh=mesh)
            metrics.append({k: float(v) for k, v in m.items()})
        out.update(metrics=metrics, trainable=_clone(state.trainable),
                   frozen=_clone(state.frozen), lrs=dict(state.tx.lrs))
    if job["full_steps"]:
        cfg = job["full_cfg"]
        state = ts.create_train_state(unet, cfg, mesh=mesh)
        metrics = []
        for draws in job["draws"][:job["full_steps"]]:
            state, m = ts.train_step(
                state, batch, None, unet=unet, text_encoder=text,
                sched=sched, cfg=cfg, draws=shard_rows(draws, rank, world),
                mesh=mesh)
            metrics.append({k: float(v) for k, v in m.items()})
        out.update(full_metrics=metrics, full_params=_clone(state.params))
    out["jax_loaded"] = _jax_loaded()
    return out


def loop_runs(job_path: str) -> dict:
    """``train_loop`` over the group, a checkpoint every step: ``steps``
    steps uninterrupted in ``a``; ``steps - 1`` steps in ``b``; a fresh
    state resumed in ``b`` to ``steps``; then ``crop_steps`` steps in ``c``
    with the temporal crop on. Returns each run's final state, the frame
    counts this rank's steps took in ``c``, the checkpoint writes it made,
    what it printed and the validation steps it ran."""
    job = torch.load(job_path, weights_only=False)
    rank, world = rank_world()
    mesh = create_mesh(world, 1, dist.group.WORLD)
    unet, text = _models(job)
    cfg = job["cfg"]
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
    batch = shard_rows(ts.TrainBatch(**job["batch"]), rank, world)
    frames, writes, validated = [], [], []

    def step_fn(state, batch, generator):
        frames.append(batch.latents.shape[1])
        return ts.train_step_partitioned(state, batch, generator, unet=unet,
                                         text_encoder=text, sched=sched,
                                         cfg=cfg, mesh=mesh)

    save = tl.CheckpointManager.save

    def counted_save(manager, step, payload):
        writes.append(step)
        save(manager, step, payload)

    tl.CheckpointManager.save = counted_save
    out = {"rank": rank}
    runs = (("a", job["steps"], False), ("b", job["steps"] - 1, False),
            ("b", job["steps"], False), ("c", job["crop_steps"], True))
    for run, (sub, steps, crop) in enumerate(runs):
        loop_cfg = tl.LoopConfig(
            output_dir=f"{job['root']}/{sub}", max_train_steps=steps,
            checkpointing_steps=1 if not crop else steps + 1, log_every=1,
            keep_checkpoints=2, temporal_multi_scale=crop,
            min_frames=job["min_frames"], validation_steps_tuple=(1,))
        state = ts.create_partitioned_train_state(unet, cfg,
                                                  frozen_dtype=torch.float32)
        del frames[:]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            state = tl.train_loop(
                state, itertools.repeat(batch), step_fn, loop_cfg, seed=3,
                validation_fn=lambda step, params: validated.append(
                    (run, step)), mesh=mesh)
        out[f"run{run}"] = {"step": state.step,
                            "count": state.opt_state["count"],
                            "trainable": _clone(state.trainable),
                            "frozen": _clone(state.frozen),
                            "mu": _clone(state.opt_state["mu"]),
                            "nu": _clone(state.opt_state["nu"]),
                            "printed": printed.getvalue()}
    out.update(frames=list(frames), writes=writes, validated=validated,
               jax_loaded=_jax_loaded())
    return out


def flow_eval(job_path: str) -> dict:
    """``evaluate_sharded`` of the job's RAFT over the group, then
    ``train_model`` one step with ``eval_every=1`` and ``eval_group`` the
    group (each rank trains on the same batch, as the JAX ``train_model``
    does on each host)."""
    from followyourclick_tpu_torch.flow import train as ttrain
    from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig

    job = torch.load(job_path, weights_only=False)
    group = dist.group.WORLD
    model = RAFT(RAFTConfig())
    model.load_state_dict(job["state"])
    out = {"eval": ttrain.evaluate_sharded(model, job["samples"],
                                           group=group, iters=job["iters"],
                                           metrics=("EPE", "Fl"))}
    if job.get("train"):
        logs = {}
        ttrain.train_model(model, iter([job["batch"]]), job["cfg"],
                           work_dir=f"{job['root']}/{rank_world()[0]}",
                           max_steps=1, resume=False,
                           log_fn=lambda step, m: logs.update(m),
                           eval_dataset=job["samples"], eval_every=1,
                           eval_group=group)
        out["logs"] = logs
    out["jax_loaded"] = _jax_loaded()
    return out
