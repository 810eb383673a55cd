"""Port parity: ``use_spatial_temporal_separate_lr`` (every leaf trains,
the motion modules on ``learning_rate``, the rest on
``spatial_learning_rate``) against the JAX step over two steps, and the
partitioned step against the full-tree one, with the harness and
tolerances of ``tests/test_torch_training_step.py``."""

import numpy as np
import torch

from followyourclick_tpu_torch.config import NoiseScheduleConfig
from followyourclick_tpu_torch.schedulers import ddim as tddim
from followyourclick_tpu_torch.training import step as ts
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import (
    EPS,
    LR,
    check,
    make_batch,
    models,
    run_both,
)


def test_separate_learning_rates():
    cfg = ts.TrainConfig(learning_rate=LR, adam_eps=EPS,
                         spatial_learning_rate=LR / 4,
                         use_spatial_temporal_separate_lr=True,
                         max_grad_norm=1e6, gradient_checkpointing=False)
    run = run_both(cfg, partitioned=False)
    check(*run, cfg)
    lrs = run[3].tx.lrs
    assert len(lrs) == len(dict(run[4].named_parameters()))
    assert {lr for n, lr in lrs.items() if "motion_modules" in n} == {LR}
    assert {lr for n, lr in lrs.items()
            if "motion_modules" not in n} == {LR / 4}


def test_partitioned_fp32_equals_full_tree():
    """``frozen_dtype=float32``: the partitioned step gives the full-tree
    step's parameters, bit for bit, over two steps (the clip off: the
    full-tree norm counts the frozen leaves' gradients too)."""
    _, _, _, _, unet, text = models()
    cfg = ts.TrainConfig(learning_rate=LR, max_grad_norm=1e6,
                         gradient_checkpointing=False)
    batch = ts.TrainBatch(**{k: torch.from_numpy(v)
                             for k, v in make_batch().items()})
    sched = tddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    full = ts.create_train_state(unet, cfg)
    part = ts.create_partitioned_train_state(unet, cfg,
                                             frozen_dtype=torch.float32)
    for step in range(2):
        for state, fn in ((full, ts.train_step),
                          (part, ts.train_step_partitioned)):
            gen = torch.Generator().manual_seed(step)
            fn(state, batch, gen, unet=unet, text_encoder=text, sched=sched,
               cfg=cfg)
    assert full.step == part.step == 2
    for n, t in part.params.items():
        assert torch.equal(t, full.params[n]), n
    moved = [n for n, t in part.trainable.items()
             if not torch.equal(t, dict(unet.named_parameters())[n])]
    assert moved and len(moved) == len(part.trainable)
    assert np.isfinite(sum(float(t.sum()) for t in part.trainable.values()))
