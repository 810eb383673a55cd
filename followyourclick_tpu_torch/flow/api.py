"""Flow inference and the motion score.

Port of ``followyourclick_tpu/flow/api.py`` (mmflow ``init_model`` /
``inference_model``) and the per-clip motion score, the mean flow
magnitude over a clip's consecutive frame pairs, which the UNet's motion
embedding takes as ``motion_score`` (``flow_control`` in training).
``init_model`` builds any registered estimator; ``inference_model`` and
``compute_motion_score`` take RAFT or GMA only, as in the JAX package,
whose other estimators take no ``iters``.

Images are uint8 or float in [0, 255], ``(H, W, 3)`` or ``(B, H, W, 3)``,
normalised as mmflow's RAFT datasets do (``(x − 127.5) / 127.5``) and edge
padded to a multiple of 8; the flow is cropped back before anything reads
it. Each call runs under :func:`utils.backend_flags.checked_precision`, on
the model's device (the card unless the model was built on the CPU), and
in eval mode, as JAX applies ``train=False``: the context encoder's BN
reads its running statistics and leaves them as they are. The model's
modes are given back afterwards, so a training loop can call them between
steps.
"""

from __future__ import annotations

import contextlib
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig
from followyourclick_tpu_torch.flow.registry import FlowEstimator
from followyourclick_tpu_torch.models.layers import BN_STATS, BatchNorm2d
from followyourclick_tpu_torch.utils.backend_flags import checked_precision
from followyourclick_tpu_torch.utils.seeded_init import seeded_init_

_MEAN = 127.5
_STD = 127.5


def init_model(config: Union[RAFTConfig, FlowEstimator, None] = None,
               checkpoint: Union[str, dict, None] = None, seed: int = 0,
               device: Union[str, torch.device] = "cuda") -> torch.nn.Module:
    """The estimator of ``config`` (a ``RAFTConfig``, or a registry
    ``FlowEstimator``; RAFT's defaults when None) in eval mode on
    ``device``: its weights and BN statistics from ``checkpoint`` (a
    ``.pth`` path, mmflow's names for RAFT / GMA and the port's for the
    others, or a state dict, loaded strictly), else drawn by
    ``utils/seeded_init`` from ``seed``."""
    device = torch.device(device)
    if not isinstance(config, FlowEstimator):
        config = FlowEstimator(RAFT, config or RAFTConfig())
    with torch.device("meta"):
        model = config.build()
    model = model.to_empty(device=device)
    for mod in model.modules():
        if isinstance(mod, BatchNorm2d):
            mod.num_batches_tracked.zero_()
    if isinstance(checkpoint, str):
        from followyourclick_tpu_torch.flow.convert import (
            load_mmflow_raft_checkpoint,
        )

        load_mmflow_raft_checkpoint(checkpoint, model)
    elif checkpoint is not None:
        model.load_state_dict(checkpoint, strict=True)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        seeded_init_(model, gen, buffers=BN_STATS)
    return model.eval()


def _prepare(images, like: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 3)`` in [0, 255] → normalised ``(B, 3, H8, W8)`` on the
    device and in the dtype of ``like``, edge padded to multiples of 8."""
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.array(images))
    x = images.to(like.device, like.dtype)
    x = ((x - _MEAN) / _STD).permute(0, 3, 1, 2).contiguous()
    h, w = x.shape[2:]
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    """``model`` in eval mode inside the block; each submodule's own mode
    restored on exit."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield
    finally:
        for m, training in modes:
            m.training = training


@checked_precision()
@torch.no_grad()
def inference_model(model: RAFT, img1, img2, iters: int = 32) -> np.ndarray:
    """The flow of one pair ``(H, W, 3)`` → ``(H, W, 2)``, or of a batch
    ``(B, H, W, 3)`` → ``(B, H, W, 2)``, float32 pixels, as numpy."""
    squeeze = np.ndim(img1) == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    h, w = np.shape(img1)[1:3]
    like = next(model.parameters())
    with _eval_mode(model):
        flow = model(_prepare(img1, like), _prepare(img2, like),
                     iters=iters)[:, :, :h, :w]
    flow = flow.permute(0, 2, 3, 1).float().cpu().numpy()
    return flow[0] if squeeze else flow


@checked_precision()
@torch.no_grad()
def compute_motion_score(model: RAFT, frames, iters: int = 12) -> float:
    """Mean optical-flow magnitude over all consecutive pairs of ``frames
    (F, H, W, 3)`` (F ≥ 2), every pair in one batch."""
    if np.ndim(frames) != 4 or np.shape(frames)[0] < 2:
        raise ValueError(f"frames must be (F >= 2, H, W, 3), got "
                         f"{tuple(np.shape(frames))}")
    h, w = np.shape(frames)[1:3]
    x = _prepare(frames, next(model.parameters()))
    with _eval_mode(model):
        flow = model(x[:-1], x[1:], iters=iters)[:, :, :h, :w]
    return float(torch.sqrt((flow ** 2).sum(dim=1)).mean())
