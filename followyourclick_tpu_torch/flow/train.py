"""Flow training: mmflow's ``train_model`` for RAFT and GMA.

Port of ``followyourclick_tpu/flow/train.py`` with the published RAFT
schedule (``raft_8x2_100k_flyingchairs_368x496``: AdamW lr 4e-4, weight
decay 1e-4, OneCycle with a 5 % linear warm-up from lr / 25, gradient
clip at norm 1, sequence loss), training on one process.

Numerics are optax's, as the JAX trainer's (:class:`FlowOptimizer`, not
``torch.optim``):

- the schedules are optax's ``join_schedules`` of two ``linear_schedule``
  and ``piecewise_constant_schedule``, evaluated in fp32, the step's
  learning rate read at the count before the update;
- ``clip_by_global_norm``: gradients scaled by ``max / norm`` only when
  ``norm >= max``;
- ``adamw``: bias-corrected moments, ``eps`` outside the square root,
  decoupled decay on the old parameter; ``adam`` (the non-RAFT families'
  schedules) folds the decay into the gradient first (L2).

A step runs the model in train mode: the context encoder's BN normalises by
the batch and moves its running statistics as flax does
(``models.layers.BatchNorm2d``). Checkpoints are ``iter_{step}.pth``
(``torch.save`` of the state dict, the optimizer state and the step, read
back with ``weights_only=True``); :func:`train_model` resumes from the
latest in its work dir and, unlike the JAX loop, first draws the batches
the saved steps took, so a resumed run takes the same step an
uninterrupted one does. Its evaluation, :func:`evaluate_sharded`, deals
the samples over the ranks of a process group.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from followyourclick_tpu_torch.flow.losses import sequence_loss
from followyourclick_tpu_torch.training.step import adam_state, adam_update
from followyourclick_tpu_torch.utils.backend_flags import checked_precision

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class FlowTrainConfig:
    """RAFT FlyingChairs schedule (raft_8x2_100k_flyingchairs_368x496.py)."""

    lr: float = 4e-4
    weight_decay: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    total_steps: int = 100100
    pct_start: float = 0.05       # OneCycle linear warm-up fraction
    grad_clip_norm: float = 1.0   # 0 disables clipping
    gamma: float = 0.8            # sequence-loss decay
    max_flow: float = 400.0
    iters: int = 12
    checkpoint_every: int = 2000
    # the non-RAFT families (mmflow schedule_s_{long,fine,short}) train
    # with torch Adam (L2 weight decay) and milestone step decay
    optimizer: str = "adamw"      # "adamw" | "adam"
    lr_policy: str = "onecycle"   # "onecycle" | "step"
    lr_milestones: Tuple[int, ...] = ()
    lr_gamma: float = 0.5

    def __post_init__(self):
        # YAML gives lists
        object.__setattr__(self, "betas", tuple(self.betas))
        object.__setattr__(self, "lr_milestones", tuple(self.lr_milestones))


_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule`` in fp32."""
    def schedule(count):
        if steps <= 0:
            return float(_F32(init))
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))
    return schedule


def onecycle_linear(cfg: FlowTrainConfig) -> Schedule:
    """Linear OneCycle: lr / 25 → lr over ``pct_start`` of the steps, then
    → 0 (``optax.join_schedules``)."""
    warm = int(cfg.total_steps * cfg.pct_start)
    up = _linear(cfg.lr / 25.0, cfg.lr, warm)
    down = _linear(cfg.lr, 0.0, cfg.total_steps - warm)
    return lambda count: up(count) if count < warm else down(count - warm)


def make_schedule(cfg: FlowTrainConfig) -> Schedule:
    if cfg.lr_policy == "step":
        # optax.piecewise_constant_schedule: lr · gamma per milestone passed
        def schedule(count):
            v = _F32(cfg.lr)
            for m in sorted(int(m) for m in cfg.lr_milestones):
                if count >= m:
                    v = _F32(cfg.lr_gamma) * v
            return float(v)
        return schedule
    if cfg.lr_policy != "onecycle":
        raise ValueError(f"unknown lr_policy {cfg.lr_policy!r}")
    return onecycle_linear(cfg)


def multistage_lr(milestone_lrs, milestone_iters, steps,
                  gammas) -> Schedule:
    """mmflow ``MultiStageLrUpdaterHook``: stage i restarts at
    ``milestone_lrs[i]`` from ``milestone_iters[i]`` and decays by
    ``gammas[i]`` at each step of ``steps[i]``."""
    if not (len(milestone_lrs) == len(milestone_iters) == len(steps)
            == len(gammas)):
        raise ValueError("one lr, start, step list and gamma a stage")
    for start, stage_steps in zip(milestone_iters, steps):
        if start >= stage_steps[0]:
            raise ValueError("milestone iter must precede its decay steps")

    def schedule(count):
        lr = _F32(milestone_lrs[0])
        for i, start in enumerate(milestone_iters):
            decays = sum(count >= s for s in steps[i])
            if count >= start:
                lr = _F32(milestone_lrs[i]) * _F32(gammas[i]) ** decays
        return float(lr)
    return schedule


class FlowOptimizer:
    """optax's ``chain(clip_by_global_norm, adamw | adam-L2)`` under a
    schedule, over named fp32 parameters, updated in place: the step's
    learning rate, read at the count before the update, given to every
    leaf of ``training.step.adam_update``."""

    def __init__(self, cfg: FlowTrainConfig):
        if cfg.optimizer not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    @staticmethod
    def init(params: Mapping[str, torch.Tensor]) -> dict:
        return adam_state(params, params)

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One update of ``params`` and ``state``; returns the gradients'
        global norm."""
        cfg = self.cfg
        lr = self.schedule(state["count"])
        return adam_update(
            grads, state, params, dict.fromkeys(params, lr), cfg.betas,
            cfg.eps, cfg.weight_decay,
            cfg.grad_clip_norm if cfg.grad_clip_norm > 0 else None,
            l2=cfg.optimizer == "adam")


def _batch(batch: Mapping[str, object],
           like: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The NHWC numpy batch of ``datasets.training_batches`` as NCHW
    tensors on the device and in the dtype of ``like`` (``valid`` stays
    (B, H, W))."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        t = t.to(like.device, like.dtype)
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.ndim == 4 else t
    return out


@checked_precision()
def train_step(model: torch.nn.Module, cfg: FlowTrainConfig,
               tx: FlowOptimizer, opt_state: dict,
               batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` (``img1``, ``img2`` (B, H, W, 3) as the JAX
    trainer feeds them, ``flow_gt`` (B, H, W, 2), optional ``valid`` (B, H,
    W)): the model's parameters, BN statistics and ``opt_state`` updated in
    place; returns the loss, the last iteration's EPE and the gradient
    norm, detached."""
    params = dict(model.named_parameters())
    b = _batch(batch, next(iter(params.values())))
    model.train()
    outs = model(b["img1"], b["img2"], iters=cfg.iters,
                 return_intermediate=True)
    loss = sequence_loss(outs, b["flow_gt"], gamma=cfg.gamma,
                         valid=b.get("valid"), max_flow=cfg.max_flow)
    epe = torch.sqrt(((outs[-1] - b["flow_gt"]) ** 2).sum(dim=1)).mean()
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    norm = tx.update(grads, opt_state, params)
    return {"loss": loss.detach(), "epe": epe.detach(), "grad_norm": norm}


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """The ``iter_{step}.pth`` of the highest step in ``work_dir``."""
    if not os.path.isdir(work_dir):
        return None
    ckpts = [f for f in os.listdir(work_dir)
             if f.startswith("iter_") and f.endswith(".pth")]
    if not ckpts:
        return None
    latest = max(ckpts, key=lambda f: int(f[len("iter_"):-len(".pth")]))
    return os.path.join(work_dir, latest)


def save_checkpoint(work_dir: str, step: int, model: torch.nn.Module,
                    opt_state: dict) -> str:
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"iter_{step}.pth")
    torch.save({"step": step, "state_dict": model.state_dict(),
                "opt_state": opt_state}, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    opt_state: dict) -> int:
    """Load ``path`` into ``model`` and ``opt_state`` in place; returns its
    step."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(saved["state_dict"], strict=True)
    opt_state["count"] = int(saved["opt_state"]["count"])
    for key in ("mu", "nu"):
        for name, t in opt_state[key].items():
            t.copy_(saved["opt_state"][key][name])
    return int(saved["step"])


def train_model(model: torch.nn.Module, data_iter: Iterable[Dict],
                cfg: FlowTrainConfig = FlowTrainConfig(),
                work_dir: str = "work_dir", max_steps: Optional[int] = None,
                resume: bool = True,
                log_fn: Optional[Callable[[int, Dict[str, float]],
                                          None]] = None,
                eval_dataset=None, eval_every: int = 0,
                eval_group=None) -> torch.nn.Module:
    """mmflow's iteration-based runner: a checkpoint every
    ``cfg.checkpoint_every`` steps, auto-resume from ``work_dir``, and every
    ``eval_every`` steps :func:`evaluate_sharded` on ``eval_dataset`` over
    ``eval_group`` (the JAX ``eval_mesh``; None: this process alone)
    logged under ``val/``. ``log_fn(step, metrics)`` also gets ``time``,
    the step's seconds on the host clock (the metrics' read waits for the
    device). Returns the model."""
    tx = FlowOptimizer(cfg)
    opt_state = tx.init(dict(model.named_parameters()))
    start = 0
    if resume:
        latest = find_latest_checkpoint(work_dir)
        if latest:
            start = load_checkpoint(latest, model, opt_state)
            data_iter = itertools.islice(iter(data_iter), start, None)
    steps = max_steps if max_steps is not None else cfg.total_steps
    for step, batch in enumerate(data_iter, start=start):
        if step >= steps:
            break
        t0 = time.perf_counter()
        metrics = train_step(model, cfg, tx, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["time"] = time.perf_counter() - t0
        if log_fn is not None:
            log_fn(step, metrics)
        if (step + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(work_dir, step + 1, model, opt_state)
        if (eval_dataset is not None and eval_every > 0
                and (step + 1) % eval_every == 0):
            val = evaluate_sharded(model, eval_dataset, group=eval_group)
            if log_fn is not None:
                log_fn(step, {f"val/{k}": v for k, v in val.items()})
    return model


def mixed_training_batches(datasets, sample_ratio, batch_size: int,
                           crop_size=(368, 496), seed: int = 0,
                           augment: bool = True):
    """mmflow ``MixedBatchDistributedSampler``: each batch draws
    ``round(ratio_i · batch_size)`` samples from dataset i, the rounding
    drift put on the largest ratio."""
    from followyourclick_tpu_torch.flow.datasets import training_batches

    if len(datasets) != len(sample_ratio):
        raise ValueError("one sample ratio a dataset")
    if abs(sum(sample_ratio) - 1.0) >= 1e-6:
        raise ValueError(f"sample ratios sum to {sum(sample_ratio)}, not 1")
    counts = [int(round(r * batch_size)) for r in sample_ratio]
    counts[int(np.argmax(sample_ratio))] += batch_size - sum(counts)
    iters = [training_batches(ds, max(c, 1), crop_size, seed + i, augment)
             for i, (ds, c) in enumerate(zip(datasets, counts))]
    while True:
        parts = []
        for it, c in zip(iters, counts):
            if c <= 0:
                continue
            b = next(it)
            parts.append({k: v[:c] for k, v in b.items()})
        yield {k: np.concatenate([p[k] for p in parts], axis=0)
               for k in parts[0]}


def evaluate(model: torch.nn.Module, dataset, iters: int = 32,
             metrics=("EPE",)) -> Dict[str, float]:
    """``flow.api.inference_model`` over every sample, reduced by
    ``flow.metrics.eval_metrics`` (mmflow's single-GPU test)."""
    from followyourclick_tpu_torch.flow.api import inference_model
    from followyourclick_tpu_torch.flow.metrics import eval_metrics

    preds, gts, valids = [], [], []
    for i in range(len(dataset)):
        s = dataset[i]
        preds.append(inference_model(model, s.img1, s.img2, iters=iters))
        gts.append(s.flow_gt)
        valids.append(s.valid)
    return eval_metrics(preds, gts, valids, list(metrics))


def evaluate_sharded(model: torch.nn.Module, dataset, group=None,
                     iters: int = 32, metrics=("EPE",)) -> Dict[str, float]:
    """mmflow's multi-GPU test (JAX ``evaluate_sharded``): rank ``r`` of
    ``group`` (None: one process) evaluates samples ``r, r + world, ...``,
    each by ``flow.api.inference_model`` (the model in eval mode, every
    module's mode given back), and keeps exact ``(EPE sum, outlier count,
    valid count)`` over the pixels with ``valid >= 0.5``; one float64
    ``all_reduce(SUM)`` joins the ranks, and every rank returns the
    dataset's EPE and KITTI Fl-all (%, an outlier is EPE > 3 px and EPE /
    (|gt| + 1e-6) > 5 %). One process a card evaluates one sample a
    forward, so no rank pads a batch. Equals :func:`evaluate` up to the
    order of the sums."""
    from followyourclick_tpu_torch.flow.api import inference_model
    from followyourclick_tpu_torch.flow.metrics import end_point_error_map
    from followyourclick_tpu_torch.parallel.data_parallel import (
        group_rank_world,
    )

    allowed = {"EPE", "Fl"}
    metrics = [metrics] if isinstance(metrics, str) else list(metrics)
    if not set(metrics).issubset(allowed):
        raise KeyError(f"metrics {set(metrics) - allowed} are not supported")
    rank, world = group_rank_world(group)
    epe_sum = out_sum = n_valid = 0.0
    for i in range(rank, len(dataset), world):
        s = dataset[i]
        flow = inference_model(model, s.img1, s.img2, iters=iters)
        val = s.valid.reshape(-1) >= 0.5
        epe = end_point_error_map(flow, s.flow_gt).reshape(-1)[val]
        epe_sum += float(epe.sum())
        n_valid += float(val.sum())
        if "Fl" in metrics:
            mag = (np.sqrt(np.sum(s.flow_gt ** 2, axis=-1)).reshape(-1)
                   + 1e-6)[val]
            out_sum += float(((epe > 3.0) & (epe / mag > 0.05)).sum())
    if group is not None:
        import torch.distributed as dist

        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
        sums = torch.tensor([epe_sum, out_sum, n_valid], dtype=torch.float64,
                            device=device)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        epe_sum, out_sum, n_valid = sums.tolist()
    out: Dict[str, float] = {}
    if "EPE" in metrics:
        out["EPE"] = epe_sum / max(n_valid, 1.0)
    if "Fl" in metrics:
        out["Fl"] = 100.0 * out_sum / max(n_valid, 1.0)
    return out
