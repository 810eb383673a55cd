"""The rank workers of the tensor-parallel tests.

Each runs inside a process of ``parallel.data_parallel.launch`` (one
``gloo`` rank, one thread) on the ``(data, model)`` grid ``job["grid"]``
(``parallel/mesh.create_mesh`` over the whole group) and imports torch and
the port only. Each reads a job the test saved with ``torch.save``, shards
its modules with ``parallel/sharding.shard_params`` and returns plain
tensors (the split ones gathered back to full) with ``jax_loaded``.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.models.unet3d import UNetConditioning
from followyourclick_tpu_torch.parallel.mesh import create_mesh
from followyourclick_tpu_torch.parallel.sharding import (
    gather_params,
    gather_slices,
    gather_tensors,
    param_sharding_rules,
    shard_batch,
    shard_params,
    split_specs,
)
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
from followyourclick_tpu_torch.training import loop as tl
from followyourclick_tpu_torch.training import step as ts
from tests._torch_ranks import _clone, _jax_loaded, _models


class FF(torch.nn.Module):
    """A GEGLU feed-forward under its JAX name ``ff``."""

    def __init__(self, dim):
        super().__init__()
        from followyourclick_tpu_torch.models.attention import (
            GEGLUFeedForward,
        )

        self.ff = GEGLUFeedForward(dim)

    def forward(self, x):
        return self.ff(x)


class Attn(torch.nn.Module):
    """An attention module under the name ``attn``."""

    def __init__(self, module):
        super().__init__()
        self.attn = module

    def forward(self, x, **kwargs):
        return self.attn(x, **kwargs)


def _mesh(job):
    return create_mesh(*job["grid"], group=dist.group.WORLD)


def _where(mesh) -> dict:
    return {"rank": dist.get_rank(), "data_rank": mesh.data_rank,
            "model_rank": mesh.model_rank}


def unet_forward(job_path: str) -> dict:
    """One forward of the job's UNet, sharded, on the data rank's rows of
    the job's inputs (``cond`` fields at the sample's batch, ``context``
    at the CFG-doubled one when ``cfg``); the full parameters gathered
    back."""
    job = torch.load(job_path, weights_only=False)
    mesh = _mesh(job)
    unet, _ = _models(job)
    shard_params(unet, mesh)
    rows = lambda x: None if x is None else shard_batch(x, mesh)  # noqa
    context = job["context"]
    if job.get("cfg"):  # [uncond; cond]: each half's rows
        u, c = context.chunk(2)
        context = torch.cat([rows(u), rows(c)])
    else:
        context = rows(context)
    cond = UNetConditioning(context=context, fps=rows(job["fps"]),
                            motion_score=rows(job["motion_score"]))
    with torch.no_grad():
        out = unet(rows(job["sample"]), rows(job["t"]), cond,
                   job.get("mode"), {})
    return {**_where(mesh), "out": out, "params": gather_params(unet),
            "local": {n: p.detach().clone()
                      for n, p in unet.named_parameters()},
            "jax_loaded": _jax_loaded()}


def train_steps(job_path: str) -> dict:
    """``job["steps"]`` partitioned steps (frozen leaves fp32) of the
    sharded UNet over the mesh, each on the data rank's rows of the global
    batch and of its draws; the state gathered back to full."""
    job = torch.load(job_path, weights_only=False)
    mesh = _mesh(job)
    unet, text = _models(job)
    shard_params(unet, mesh)
    cfg = job["cfg"]
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
    batch = shard_batch(ts.TrainBatch(**job["batch"]), mesh)
    state = ts.create_partitioned_train_state(
        unet, cfg, frozen_dtype=torch.float32, mesh=mesh)
    metrics = []
    for draws in job["draws"][:job["steps"]]:
        state, m = ts.train_step_partitioned(
            state, batch, None, unet=unet, text_encoder=text, sched=sched,
            cfg=cfg, draws=shard_batch(draws, mesh), mesh=mesh)
        metrics.append({k: float(v) for k, v in m.items()})
    split = state.tx.split
    return {**_where(mesh), "metrics": metrics,
            "trainable": gather_tensors(state.trainable, split, mesh),
            "frozen": gather_tensors(state.frozen, split, mesh),
            "lrs": dict(state.tx.lrs), "split": sorted(split),
            "jax_loaded": _jax_loaded()}


def loop_runs(job_path: str) -> dict:
    """``train_loop`` on the mesh, a checkpoint every step: ``steps``
    steps uninterrupted in ``a``; ``steps - 1`` steps in ``b``, then a
    fresh state resumed in ``b`` to ``steps``; then a fresh state resumed
    in ``c`` (a one-process run's checkpoint of ``steps - 1`` steps, which
    the test wrote) to ``steps``. The first run validates at its last
    step. Returns each run's state gathered, and the params each
    ``validation_fn`` call on this rank was given."""
    job = torch.load(job_path, weights_only=False)
    mesh = _mesh(job)
    unet, text = _models(job)
    shard_params(unet, mesh)
    cfg = job["cfg"]
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
    batch = shard_batch(ts.TrainBatch(**job["batch"]), mesh)

    def step_fn(state, batch, generator):
        return ts.train_step_partitioned(state, batch, generator, unet=unet,
                                         text_encoder=text, sched=sched,
                                         cfg=cfg, mesh=mesh)

    out = _where(mesh)
    validated = []
    runs = (("a", job["steps"]), ("b", job["steps"] - 1),
            ("b", job["steps"]), ("c", job["steps"]))
    for run, (sub, steps) in enumerate(runs):
        loop_cfg = tl.LoopConfig(
            output_dir=f"{job['root']}/{sub}", max_train_steps=steps,
            checkpointing_steps=1, log_every=100, keep_checkpoints=3,
            temporal_multi_scale=False,
            validation_steps_tuple=(steps,) if run == 0 else ())
        state = ts.create_partitioned_train_state(
            unet, cfg, frozen_dtype=torch.float32, mesh=mesh)
        state = tl.train_loop(
            state, itertools.repeat(batch), step_fn, loop_cfg, seed=3,
            validation_fn=lambda step, params: validated.append(
                (step, _clone(params))), mesh=mesh)
        split = state.tx.split
        out[f"run{run}"] = {
            "step": state.step, "count": state.opt_state["count"],
            "trainable": gather_tensors(state.trainable, split, mesh),
            "frozen": gather_tensors(state.frozen, split, mesh),
            "mu": gather_tensors(state.opt_state["mu"], split, mesh),
            "nu": gather_tensors(state.opt_state["nu"], split, mesh)}
    out.update(validated=validated, jax_loaded=_jax_loaded())
    return out


def requests(job_path: str) -> dict:
    """Each of ``job["specs"]`` as one request of the job's clips through
    ``AnimationPipeline(mesh=)`` (UNet and VAE sharded over ``model``, the
    clips over ``data``), the noise drawn from a seeded generator, or the
    whole request's ``noise`` / ``step_noise`` of ``job["draws"]``."""
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )

    job = torch.load(job_path, weights_only=False)
    mesh = _mesh(job)
    cfg = job["config"]
    unet = UNet3DConditionModel(cfg.unet)
    unet.load_state_dict(job["unet_state"])
    vae = AutoencoderKL(cfg.vae)
    vae.load_state_dict(job["vae_state"])
    text = CLIPTextModel(cfg.clip_text)
    text.load_state_dict(job["text_state"])
    pipe = AnimationPipeline(cfg, unet, vae, text, device="cpu", mesh=mesh)
    draws = job.get("draws") or [
        {"generator": torch.Generator().manual_seed(job["seed"])}
        for _ in job["specs"]]
    videos = [pipe.sample(*job["inputs"], spec=spec, **kw)
              for spec, kw in zip(job["specs"], draws)]
    return {**_where(mesh), "videos": videos, "jax_loaded": _jax_loaded()}


def modules(job_path: str) -> dict:
    """Each of ``job["modules"]`` (a module whose tensor-parallel children
    sit under the JAX names), sharded over the mesh: its output on the
    job's input and the gradients of the input and of every parameter
    under the job's cotangent, split ones gathered back to full."""
    job = torch.load(job_path, weights_only=False)
    mesh = _mesh(job)
    out = _where(mesh)
    for name, (module, x, cot, kwargs) in job["modules"].items():
        specs = split_specs(param_sharding_rules(module))
        shard_params(module, mesh)
        x = x.clone().requires_grad_()
        y = module(x, **kwargs)
        y.backward(cot)
        grads = {n: p.grad for n, p in module.named_parameters()}
        out[name] = {
            "out": y.detach(), "x_grad": x.grad,
            "grads": {n: gather_slices(g, *specs[n], mesh) if n in specs
                      else g for n, g in grads.items()},
            "params": _clone(gather_params(module))}
    out["jax_loaded"] = _jax_loaded()
    return out
