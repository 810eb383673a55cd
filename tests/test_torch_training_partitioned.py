"""Port parity: the partitioned train step (fp32 masters of the trainable
leaves, the frozen ones apart) against the JAX ``train_step_partitioned``
over two steps, with the clip engaged (``max_grad_norm`` far below the
gradients' norm), weight decay and the whole-call checkpoint, in the
harness and tolerances of ``tests/test_torch_training_step.py``."""

import torch

from followyourclick_tpu_torch.training import step as ts
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import EPS, LR, check, run_both


def test_partitioned_step_matches_jax():
    cfg = ts.TrainConfig(learning_rate=LR, adam_eps=EPS, max_grad_norm=1e-3,
                         weight_decay=1e-2, gradient_checkpointing=True)
    run = run_both(cfg, partitioned=True, frozen_dtype=torch.float32)
    assert run[0][0]["grad_norm"] > 100 * cfg.max_grad_norm
    check(*run, cfg)
