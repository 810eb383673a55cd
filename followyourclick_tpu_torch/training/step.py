"""The v-prediction training step with masked AdamW.

Port of ``followyourclick_tpu/training/train_step.py``: v-prediction MSE on
the zero-SNR DDIM schedule, the first-frame masked-latent conditioning with
random corruption over ``mask_corruption_rates``, the reference recipe's
trainable-module filter (``motion_modules``, ``conv_in``,
``motion_embedding``, ``fps_embedding``) or, under
``use_spatial_temporal_separate_lr``, every parameter on two learning rates.

Parameters live in dicts keyed by the UNet's torch names; the UNet module is
run on them with ``torch.func.functional_call``. Which leaves train is
decided on each parameter's JAX path (``utils/convert.flax_paths``), as the
JAX ``trainable_mask`` walks the flax tree. The optimizer is
:class:`MaskedAdamW`, plain tensor code with optax's numerics (not
``torch.optim.AdamW`` and ``clip_grad_norm_``, whose clip adds 1e-6 to the
norm and always scales):

- ``optax.clip_by_global_norm``: the gradients are scaled by ``max / norm``
  only when ``norm >= max``; the norm is over every gradient the step
  takes, frozen leaves' too in :func:`train_step` (which then drops them);
- ``optax.adamw``: fp32 moments (the first in ``adam_mu_dtype`` when set,
  updated in fp32 and stored rounded), bias correction, ``eps`` outside the
  square root, weight decay on the old parameter, scaled by the learning
  rate.

Two layouts, as in JAX. :func:`train_step` holds the whole tree in fp32 and
takes every gradient; :func:`train_step_partitioned` holds fp32 masters of
the trainable leaves only, the frozen ones in ``frozen_dtype`` (bf16 by
default), and takes gradients of the trainable leaves alone, cast to the
frozen dtype for the forward. With ``frozen_dtype=torch.float32`` the two
give the same update when the clip does not engage.

The state's tensors are updated in place: a step returns the state it was
given. Random draws come from an explicit ``torch.Generator`` (on the
batch's device); ``draws=`` takes them from the caller instead (the tests
feed the JAX draws).

Over ranks (``mesh=``, a ``parallel/mesh.create_mesh`` grid; a
data-parallel run is ``create_mesh(world, 1, group)``), the JAX step on a
mesh with the batch on ``P("data")``: each rank holds its rows of the
global batch; the draws are drawn at the global batch's shape from the
step's generator (the same on every rank) and each rank takes its rows, so
``world`` ranks take the step one process takes over the whole batch. The
gradients and the loss are averaged over the ranks before the optimizer,
so its global-norm clip, Adam and the decay see the global gradient and
every rank takes the same update. The states start from rank 0's leaves.

On a mesh with model ranks (the partitioned layout), the JAX step on a
mesh whose UNet is sharded by ``parallel/sharding``: the UNet runs on
this rank's slices (``shard_params`` before the state is made), the
state holds the rank's slices of the split leaves (masters, moments)
with its masks decided on the full names, the draws are made at the
global batch's shape and sliced by the data rank (both model ranks of a
data row draw alike), and the gradients and the loss are averaged over
the data ranks only. The global norm of the clip and of ``grad_norm``
sums the squares of the split leaves over the model ranks and counts the
replicated leaves once, as JAX's norm over the full arrays. Checkpointed
blocks recompute their collectives in the backward, in the same order on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from followyourclick_tpu_torch.models.unet3d import UNetConditioning
from followyourclick_tpu_torch.parallel.data_parallel import (
    all_reduce_mean_,
    broadcast_,
    group_rank_world,
    shard_rows,
)
from followyourclick_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    add_noise,
    get_velocity,
)
from followyourclick_tpu_torch.utils.convert import flax_paths

_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    # the reference trainable_modules name-prefix filters
    trainable_modules: Sequence[str] = (
        "motion_modules", "conv_in", "motion_embedding", "fps_embedding")
    # mask-corruption rates of the first-frame conditioning latent
    mask_corruption_rates: Sequence[float] = (0.0, 0.3, 0.5, 0.7)
    # one torch.utils.checkpoint around the whole UNet call
    gradient_checkpointing: bool = True
    # every parameter trains: the motion modules on learning_rate, the rest
    # on spatial_learning_rate (learning_rate when None)
    use_spatial_temporal_separate_lr: bool = False
    spatial_learning_rate: Optional[float] = None
    # AdamW's first moment stored in this dtype ("bfloat16"); None: fp32
    adam_mu_dtype: Optional[str] = None


def trainable_mask(module: nn.Module,
                   prefixes: Sequence[str]) -> dict:
    """Torch name → True where a segment of the parameter's JAX path starts
    with one of ``prefixes`` (the JAX ``trainable_mask``)."""
    return {name: any(seg.startswith(p) for seg in path for p in prefixes)
            for name, path in flax_paths(module).items()}


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm over every element, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def sharded_global_norm(grads: Mapping[str, torch.Tensor], split,
                        mesh) -> torch.Tensor:
    """:func:`global_norm` of the full gradients from this rank's: the
    squares of the leaves named in ``split`` summed over the model ranks,
    the replicated leaves counted once."""
    from followyourclick_tpu_torch.parallel.tensor_parallel import (
        reduce_from_model,
    )

    zero = torch.zeros((), device=next(iter(grads.values())).device)
    mine = sum((t.float().square().sum() for n, t in grads.items()
                if n in split), zero)
    rest = sum((t.float().square().sum() for n, t in grads.items()
                if n not in split), zero)
    return torch.sqrt(reduce_from_model(mine, mesh) + rest)


def adam_state(params: Mapping[str, torch.Tensor], names,
               mu_dtype: Optional[torch.dtype] = None) -> dict:
    """Zero moments of the leaves ``names`` of ``params`` (the first in
    ``mu_dtype`` when given) and a count of 0."""
    return {"count": 0,
            "mu": {n: torch.zeros_like(params[n], dtype=mu_dtype)
                   for n in names},
            "nu": {n: torch.zeros_like(params[n]) for n in names}}


@torch.no_grad()
def adam_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                params: Mapping[str, torch.Tensor], lrs: Mapping[str, float],
                betas: Tuple[float, float], eps: float, weight_decay: float,
                max_norm: Optional[float], l2: bool = False,
                norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of optax's ``chain(clip_by_global_norm(max_norm), adamw)``
    over the leaves of ``lrs``, each at its learning rate; with ``l2``,
    ``add_decayed_weights`` before ``scale_by_adam`` instead of the
    decoupled decay (torch Adam's L2). ``max_norm=None`` does not clip.
    Updates ``params`` and ``opt_state`` in place; returns the global norm
    of every gradient in ``grads`` (``norm`` when the caller gives it)."""
    if norm is None:
        norm = global_norm(grads.values())
    opt_state["count"] += 1
    count = np.float32(opt_state["count"])
    b1, b2 = betas
    bc1 = float(np.float32(1) - np.float32(b1) ** count)
    bc2 = float(np.float32(1) - np.float32(b2) ** count)
    for name, lr in lrs.items():
        p, g = params[name], grads[name]
        if max_norm is not None:
            g = torch.where(norm < max_norm, g, g / norm * max_norm)
        if l2:
            g = g + weight_decay * p
        mu0 = opt_state["mu"][name]
        # optax's weakly typed decay takes the moment's dtype
        mu = (1 - b1) * g + mu0 * torch.tensor(b1, dtype=mu0.dtype)
        nu = (1 - b2) * g.square() + b2 * opt_state["nu"][name]
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if not l2:
            u = u + weight_decay * p
        p.add_(u * -lr)
        mu0.copy_(mu)
        opt_state["nu"][name].copy_(nu)
    return norm


class MaskedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), multi_transform(...))``
    over named fp32 leaves: ``lrs`` maps each leaf that trains to its
    learning rate (a leaf not in it is ``set_to_zero``). With a ``mesh``
    the leaves are a model rank's slices and ``split`` (name → ``(dim,
    halves)``, ``parallel/sharding.split_specs``) names the split ones:
    the norm is :func:`sharded_global_norm`."""

    def __init__(self, cfg: TrainConfig, lrs: Mapping[str, float],
                 split: Optional[Mapping] = None, mesh=None):
        self.cfg = cfg
        self.lrs = dict(lrs)
        self.mu_dtype = _DTYPES[cfg.adam_mu_dtype]
        self.split = dict(split or {})
        self.mesh = mesh

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return adam_state(params, self.lrs, self.mu_dtype)

    def update(self, grads: Mapping[str, torch.Tensor], opt_state: dict,
               params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Update ``params`` and ``opt_state`` in place from ``grads``;
        returns the global norm of ``grads``."""
        cfg = self.cfg
        norm = None
        if self.mesh is not None and self.mesh.model_size > 1:
            norm = sharded_global_norm(grads, self.split, self.mesh)
        return adam_update(grads, opt_state, params, self.lrs,
                           (cfg.adam_beta1, cfg.adam_beta2), cfg.adam_eps,
                           cfg.weight_decay, cfg.max_grad_norm, norm=norm)


def _labels_lrs(module: nn.Module, names, cfg: TrainConfig) -> dict:
    """Learning rate of each training leaf among ``names``."""
    if cfg.use_spatial_temporal_separate_lr:
        temporal = trainable_mask(module, ("motion_modules",))
        spatial = (cfg.spatial_learning_rate
                   if cfg.spatial_learning_rate is not None
                   else cfg.learning_rate)
        return {n: cfg.learning_rate if temporal[n] else spatial
                for n in names}
    mask = trainable_mask(module, tuple(cfg.trainable_modules))
    return {n: cfg.learning_rate for n in names if mask[n]}


def _params(module: nn.Module, params) -> dict:
    if params is None:
        params = dict(module.named_parameters())
    return {n: t.detach() for n, t in params.items()}


@dataclasses.dataclass
class TrainState:
    """The whole tree in fp32 with the optimizer state of the leaves that
    train."""

    step: int
    params: dict
    opt_state: dict
    tx: MaskedAdamW


def _data_group(mesh):
    """The process group of ``mesh``'s data axis (None off a mesh)."""
    return None if mesh is None else mesh.data_group


def _tx(unet: nn.Module, cfg: TrainConfig, lrs, mesh) -> "MaskedAdamW":
    """The optimizer; on a mesh with model ranks, told the split leaves
    (``unet`` sharded by ``parallel/sharding.shard_params``)."""
    if mesh is None or mesh.model_size == 1:
        return MaskedAdamW(cfg, lrs)
    from followyourclick_tpu_torch.parallel.sharding import (
        param_sharding_rules,
        split_specs,
    )

    if getattr(unet, "_tp_mesh", None) is not mesh:
        raise ValueError("the UNet is not sharded on this mesh: call "
                         "parallel.sharding.shard_params(unet, mesh) first")
    return MaskedAdamW(cfg, lrs, split_specs(param_sharding_rules(unet)),
                       mesh)


def create_train_state(unet: nn.Module, cfg: TrainConfig,
                       params: Optional[Mapping] = None,
                       mesh=None) -> TrainState:
    """The full-tree state from ``params`` (the module's own by default);
    trainable leaves are copied, frozen ones kept as they are. Over a
    ``mesh``'s data ranks every leaf takes rank 0's values."""
    if mesh is not None and mesh.model_size > 1:
        raise ValueError("the full-tree state has no model ranks: use "
                         "create_partitioned_train_state")
    params = _params(unet, params)
    lrs = _labels_lrs(unet, params, cfg)
    params = {n: t.to(torch.float32, copy=n in lrs) for n, t in
              params.items()}
    broadcast_(params, 0, _data_group(mesh))
    tx = MaskedAdamW(cfg, lrs)
    return TrainState(0, params, tx.init(params), tx)


def partition_params(params: Mapping, mask: Mapping) -> Tuple[dict, dict]:
    """Split one dict into (trainable, frozen) by ``mask``."""
    return ({n: t for n, t in params.items() if mask[n]},
            {n: t for n, t in params.items() if not mask[n]})


def merge_params(trainable: Mapping, frozen: Mapping) -> dict:
    """Inverse of :func:`partition_params`."""
    return {**frozen, **trainable}


@dataclasses.dataclass
class PartitionedTrainState:
    """fp32 masters of the trainable leaves with their optimizer state; the
    frozen leaves in their own dtype, never updated."""

    step: int
    trainable: dict
    frozen: dict
    opt_state: dict
    tx: MaskedAdamW

    @property
    def params(self) -> dict:
        """The merged dict (checkpoints, validation sampling)."""
        return merge_params(self.trainable, self.frozen)


def create_partitioned_train_state(
        unet: nn.Module, cfg: TrainConfig,
        frozen_dtype: Optional[torch.dtype] = torch.bfloat16,
        params: Optional[Mapping] = None,
        mesh=None) -> PartitionedTrainState:
    """The memory-lean state: fp32 copies of the leaves that train, the
    rest cast to ``frozen_dtype`` (kept as they are when None or already
    that dtype). ``frozen_dtype=torch.float32`` gives :func:`train_step`'s
    update. Over a ``mesh``'s data ranks every leaf takes rank 0's
    values; with model ranks the leaves are the rank's slices of the
    sharded ``unet``."""
    group = _data_group(mesh)
    params = _params(unet, params)
    lrs = _labels_lrs(unet, params, cfg)
    trainable, frozen = partition_params(params, {n: n in lrs
                                                  for n in params})
    trainable = {n: t.to(torch.float32, copy=True)
                 for n, t in trainable.items()}
    if frozen_dtype is not None:
        frozen = {n: t.to(frozen_dtype) if t.is_floating_point() else t
                  for n, t in frozen.items()}
    broadcast_(trainable, 0, group)
    broadcast_(frozen, 0, group)
    tx = _tx(unet, cfg, lrs, mesh)
    return PartitionedTrainState(0, trainable, frozen, tx.init(trainable),
                                 tx)


@dataclasses.dataclass
class TrainBatch:
    """One training batch of scaled latents (the dataset gives pixel
    videos; :func:`encode_batch` makes the latents)."""

    latents: torch.Tensor      # (B, F, h, w, 4)
    input_ids: torch.Tensor    # (B, 77)
    mask: torch.Tensor         # (B, h, w, 1) motion-area / click mask
    fps: torch.Tensor          # (B,) dynamic-fps conditioning
    motion_score: torch.Tensor  # (B,) optical-flow magnitude


@dataclasses.dataclass
class StepDraws:
    """The step's random draws (the JAX step's four ``jax.random`` keys)."""

    timesteps: torch.Tensor    # (B,) int in [0, num_train_timesteps)
    noise: torch.Tensor        # (B, F, h, w, 4)
    rate_index: torch.Tensor   # (B,) int in [0, len(rates))
    uniform: torch.Tensor      # (B, h, w, 1) in [0, 1)


def draw_step(latents: torch.Tensor, sched: DDIMSchedule, cfg: TrainConfig,
              generator: torch.Generator, group=None) -> StepDraws:
    """The step's draws from ``generator``, in the JAX step's order. Over
    ``group`` (a mesh's ``data_group``), ``latents`` are this rank's
    rows: the draws are made at the global batch's shape and this rank's
    rows returned."""
    rank, world = group_rank_world(group)
    b, f, h, w, c = latents.shape
    b *= world
    kw = dict(generator=generator, device=latents.device)
    return shard_rows(StepDraws(
        torch.randint(0, sched.cfg.num_train_timesteps, (b,), **kw),
        torch.randn((b, f, h, w, c), dtype=latents.dtype, **kw),
        torch.randint(0, len(cfg.mask_corruption_rates), (b,), **kw),
        torch.rand((b, h, w, 1), **kw)), rank, world)


def encode_batch(vae: nn.Module, video: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 group=None) -> torch.Tensor:
    """``(B, F, H, W, 3)`` in [-1, 1] → scaled latents ``(B, F, H/8, W/8,
    4)``: the VAE posterior's reparameterised sample × 0.18215, frames
    folded into the batch; ``noise`` (``(B·F, H/8, W/8, 4)``) in place of a
    draw from ``generator``. Over ``group`` (a mesh's ``data_group``),
    ``video`` is this rank's clips:
    the noise is drawn for the global batch and this rank's rows taken."""
    b, f, h, w, c = video.shape
    with torch.no_grad():
        mean, logvar = vae.encode(video.reshape(b * f, h, w, c))
        if noise is None:
            rank, world = group_rank_world(group)
            noise = shard_rows(torch.randn(
                (world * mean.shape[0],) + tuple(mean.shape[1:]),
                generator=generator, device=mean.device, dtype=mean.dtype),
                rank, world)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean)
    return z.reshape(b, f, h // 8, w // 8, 4) * 0.18215


def _prepare_step_inputs(batch: TrainBatch, draws: StepDraws,
                         sched: DDIMSchedule, cfg: TrainConfig,
                         text_encoder: nn.Module):
    """Noising, the v-target, the first-frame mask conditioning with its
    random corruption, and the (frozen) text context."""
    lat = batch.latents
    b, f, h, w, _ = lat.shape
    noisy = add_noise(sched, lat, draws.noise, draws.timesteps)
    target = get_velocity(sched, lat, draws.noise, draws.timesteps)
    rates = torch.tensor(cfg.mask_corruption_rates, dtype=torch.float32,
                         device=lat.device)
    rate = rates[draws.rate_index]
    keep = (draws.uniform >= rate[:, None, None, None]).to(lat.dtype)
    first_block = torch.zeros_like(lat)
    first_block[:, 0] = lat[:, 0] * keep
    mask_block = batch.mask.clamp(0.0, 1.0)[:, None].expand(b, f, h, w, 1)
    model_in = torch.cat([noisy, mask_block.to(noisy.dtype),
                          first_block.to(noisy.dtype)], dim=-1)
    with torch.no_grad():
        context, _ = text_encoder(batch.input_ids)
    cond = UNetConditioning(context=context, fps=batch.fps,
                            motion_score=batch.motion_score)
    return model_in, draws.timesteps, cond, target


def _unet_apply(unet: nn.Module, cfg: TrainConfig):
    """``apply(params, sample, timesteps, cond)``; under
    ``gradient_checkpointing`` one checkpoint region around the whole call
    (JAX ``jax.checkpoint(..., nothing_saveable)``)."""
    def apply(params, *args):
        return functional_call(unet, params, args)

    if not cfg.gradient_checkpointing:
        return apply
    return lambda params, *args: checkpoint(apply, params, *args,
                                            use_reentrant=False)


def _mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


def _step_draws(batch, generator, sched, cfg, draws, mesh):
    return draws if draws is not None else draw_step(
        batch.latents, sched, cfg, generator, _data_group(mesh))


def _global_mean(loss: torch.Tensor, grads: dict, mesh):
    """The loss and ``grads`` averaged over ``mesh``'s data ranks (in
    place)."""
    group = _data_group(mesh)
    loss = loss.detach()
    all_reduce_mean_(grads, group)
    if group is not None:
        loss = all_reduce_mean_([loss.clone()], group)[0]
    return loss, grads


def train_step(state: TrainState, batch: TrainBatch,
               generator: Optional[torch.Generator], *, unet: nn.Module,
               text_encoder: nn.Module, sched: DDIMSchedule,
               cfg: TrainConfig, draws: Optional[StepDraws] = None,
               mesh=None):
    """One v-prediction step over the whole tree; ``(state, metrics)``.
    Over a ``mesh``'s data ranks, ``batch`` (and ``draws`` when given) are
    this rank's rows; the metrics are the global batch's."""
    model_in, timesteps, cond, target = _prepare_step_inputs(
        batch, _step_draws(batch, generator, sched, cfg, draws, mesh),
        sched, cfg, text_encoder)
    leaves = {n: t.detach().requires_grad_() if t.is_floating_point()
              else t for n, t in state.params.items()}
    with torch.enable_grad():
        loss = _mse(_unet_apply(unet, cfg)(leaves, model_in, timesteps,
                                           cond), target)
        names = [n for n, t in leaves.items() if t.requires_grad]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
    loss, grads = _global_mean(loss, grads, mesh)
    norm = state.tx.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, {"loss": loss, "grad_norm": norm}


def partitioned_loss_and_grads(state: PartitionedTrainState,
                               batch: TrainBatch, draws: StepDraws, *,
                               unet: nn.Module, text_encoder: nn.Module,
                               sched: DDIMSchedule, cfg: TrainConfig,
                               mesh=None):
    """The loss and the trainable leaves' gradients of one step, the state
    untouched: the trainable leaves cast to the frozen leaves' dtype for
    the forward (fp32 masters keep the update's precision). On a
    ``mesh``, ``batch`` and ``draws`` are this data rank's rows and both
    results are averaged over the data ranks."""
    model_in, timesteps, cond, target = _prepare_step_inputs(
        batch, draws, sched, cfg, text_encoder)
    floating = [t.dtype for t in state.frozen.values()
                if t.is_floating_point()]
    compute = floating[0] if floating else None
    masters = {n: t.detach().requires_grad_()
               for n, t in state.trainable.items()}
    with torch.enable_grad():
        cast = {n: t.to(compute) if compute not in (None, torch.float32)
                and t.is_floating_point() else t for n, t in masters.items()}
        loss = _mse(_unet_apply(unet, cfg)(
            merge_params(cast, state.frozen), model_in, timesteps, cond),
            target)
        grads = dict(zip(masters, torch.autograd.grad(
            loss, list(masters.values()))))
    return _global_mean(loss, grads, mesh)


def train_step_partitioned(state: PartitionedTrainState, batch: TrainBatch,
                           generator: Optional[torch.Generator], *,
                           unet: nn.Module, text_encoder: nn.Module,
                           sched: DDIMSchedule, cfg: TrainConfig,
                           draws: Optional[StepDraws] = None, mesh=None):
    """:func:`train_step`'s math with gradients of the trainable leaves
    only (:func:`partitioned_loss_and_grads`); ``(state, metrics)``."""
    loss, grads = partitioned_loss_and_grads(
        state, batch, _step_draws(batch, generator, sched, cfg, draws, mesh),
        unet=unet, text_encoder=text_encoder, sched=sched, cfg=cfg,
        mesh=mesh)
    norm = state.tx.update(grads, state.opt_state, state.trainable)
    state.step += 1
    return state, {"loss": loss, "grad_norm": norm}
