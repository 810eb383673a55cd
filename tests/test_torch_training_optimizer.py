"""Port parity: the masked AdamW (``training/step.MaskedAdamW``) against
optax, and the train step with the clip engaged, weight decay and a bf16
first moment.

The optimizer alone: the JAX package's optimizer chains (through its
``create_train_state`` / ``create_partitioned_train_state``) and the
port's take the same gradients for three steps, at the default
``adam_eps = 1e-8``, with gradients down to 1e-10 and exact zeros among
them; parameters, first and second moments must agree within ``1e-3 · lr``
a step (the inputs are the same, so only the last bit of an operation may
differ). The step (``tests/test_torch_training_step.py``'s harness): one
partitioned fp32 step with a bf16 first moment: from the second step on, a moment
that lies within the two packages' fp32 difference of a bf16 rounding
boundary rounds to neighbouring bf16 values, which moves its leaf by up to
0.4 % of ``lr``, so the bf16 moment is held over one step and, stored, to
one bf16 ulp of the JAX one (plus 1e-5 of the leaf's largest, the fp32
gradients' difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.training import step as ts
from followyourclick_tpu_torch.utils.convert import export_jax_params
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import (
    EPS,
    LR,
    check,
    flat,
    jts,
    jax_config,
    run_both,
)

STEPS = 3


def grads_tree(rs, shapes, step):
    """Gradients of every scale, from a seed: normal leaves times a per-leaf
    scale between 1e-10 and 1, with one exact zero per leaf."""
    out = {}
    for i, (k, shape) in enumerate(shapes.items()):
        g = rs.randn(*shape).astype(np.float32) * 10.0 ** -(
            (i + step) % 11)
        g.reshape(-1)[0] = 0.0
        out[k] = g
    return out


def nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        for seg in k.split("/")[:-1]:
            node = node.setdefault(seg, {})
        node[k.split("/")[-1]] = v
    return tree


SHAPES = {"motion_modules_0/to_q/kernel": (8, 16),
          "motion_modules_0/norm/scale": (16,),
          "conv_in/conv/kernel": (3, 3, 4, 8),
          "conv_in/conv/bias": (8,),
          "resnets_0/conv1/kernel": (3, 3, 8, 8),
          "resnets_0/norm1/bias": (8,)}


@pytest.mark.parametrize("cfg", [
    ts.TrainConfig(learning_rate=1e-3),
    ts.TrainConfig(learning_rate=1e-3, max_grad_norm=1e-4,
                   weight_decay=1e-2),
    ts.TrainConfig(learning_rate=1e-3, adam_mu_dtype="bfloat16",
                   max_grad_norm=1e-4),
    ts.TrainConfig(learning_rate=1e-3, spatial_learning_rate=2e-4,
                   use_spatial_temporal_separate_lr=True,
                   weight_decay=1e-2),
], ids=["default", "clip_decay", "mu_bf16", "separate_lr"])
@pytest.mark.parametrize("layout", ["full_tree", "partitioned"])
def test_optimizer_matches_optax(cfg, layout):
    rs = np.random.RandomState(0)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jcfg = jax_config(cfg)
    tree = nest({k: jnp.asarray(v) for k, v in params.items()})
    if layout == "full_tree":
        jstate = jts.create_train_state(tree, jcfg)
        names = list(params)
    else:
        jstate = jts.create_partitioned_train_state(tree, jcfg,
                                                    frozen_dtype=None)
        names = [k for k in params if cfg.use_spatial_temporal_separate_lr
                 or k.split("/")[0] in ("motion_modules_0", "conv_in")]
    if cfg.use_spatial_temporal_separate_lr:
        lrs = {k: cfg.learning_rate if k.startswith("motion_modules")
               else cfg.spatial_learning_rate for k in params}
    else:
        lrs = {k: cfg.learning_rate for k in params
               if k.split("/")[0] in ("motion_modules_0", "conv_in")}
    tx = ts.MaskedAdamW(cfg, lrs)
    tparams = {k: torch.tensor(params[k]) for k in names}
    opt = tx.init(tparams)
    for step in range(STEPS):
        g = grads_tree(rs, SHAPES, step)
        norm = tx.update({k: torch.tensor(g[k]) for k in names}, opt,
                         tparams)
        jg = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(g["/".join(p.key for p in path)]),
            jstate.params if layout == "full_tree" else jstate.trainable)
        want_norm = float(np.sqrt(sum(np.sum(np.square(g[k], dtype=np.float64))
                                      for k in names)))
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
        jstate = jstate.apply_gradients(jg)
    jflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            elif v is not None:
                jflat["/".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(jstate.params, ())
    bound = STEPS * 1e-3 * cfg.learning_rate
    for k in names:
        np.testing.assert_allclose(tparams[k].numpy(), jflat[k], rtol=0,
                                   atol=bound, err_msg=k)
        if k not in lrs:
            np.testing.assert_array_equal(tparams[k].numpy(), params[k])


def test_step_mu_bf16():
    """One partitioned fp32 step with a bf16 first moment: the update
    within ``1e-3 · lr``, the stored moment within one bf16 ulp."""
    cfg = ts.TrainConfig(learning_rate=LR, adam_eps=EPS,
                         adam_mu_dtype="bfloat16",
                         gradient_checkpointing=False)
    run = run_both(cfg, partitioned=True, frozen_dtype=torch.float32,
                   steps=1)
    check(*run, cfg, steps=1)
    mu = run[3].opt_state["mu"]
    assert {t.dtype for t in mu.values()} == {torch.bfloat16}
    jmu = flat(run[1].opt_state[1][0].mu)
    got = flat(export_jax_params(run[4], mu, like=run[1].trainable))
    assert got.keys() == jmu.keys()
    for k, want in jmu.items():
        # one bf16 ulp, plus the fp32 gradients' difference (1e-5 of the
        # leaf's largest) where a gradient is near zero
        tol = (2.0 ** -7 * np.maximum(np.abs(want), np.abs(got[k]))
               + 1e-5 * np.abs(want).max())
        assert np.all(np.abs(got[k] - want) <= tol), k
