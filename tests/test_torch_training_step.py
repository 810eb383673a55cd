"""Port parity: the v-prediction train step and masked AdamW.

A two-level tiny UNet (widths 32 and 64, 8 groups, 4 motion heads; the
topology of ``__graft_entry__.dryrun_multichip``) and a one-layer CLIP run
two train steps in fp32 on the CPU through the jitted JAX step and the
port's, b = 2 clips of 4 frames at 16² latents, every parameter random
(``tests/test_torch_unet.random_tree``: no zero-initialised layer, so every
trainable leaf gets a gradient at step 1). The port's step takes the JAX
step's draws (timesteps, noise, corruption rate, corruption mask) through
``draws=``.

Tolerances: loss and ``grad_norm`` 1e-5 relative (fp32, the sums in
another order); every parameter after two steps within ``2 · UPDATE_TOL ·
lr`` of the JAX one (``UPDATE_TOL = 1e-3`` a step): Adam's first steps move
each leaf by about ``lr · sign(g)``, so the bound is on that scale. The
steps run at ``adam_eps = EPS = 1e-5``: Adam's first update ``g / (|g| +
eps)`` turns an absolute gradient difference Δg into up to ``Δg / (4·eps)``
of ``lr``, and the two packages' fp32 gradients differ by ~1e-9 where they
sum in another order, which at the default eps of 1e-8 moves a near-zero
gradient's leaf by 4 % of ``lr`` (measured) whatever the port does. The
optimizer alone is held to optax at the default eps in
``tests/test_torch_training_optimizer.py``, which also runs the step with
a bf16 first moment; ``tests/test_torch_training_partitioned.py`` the
partitioned step with the clip engaged and weight decay;
``tests/test_torch_training_separate_lr.py`` the two learning rates and the
partitioned step against the full-tree one (one JAX compile a file). The
frozen leaves must be unchanged, bit for bit.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from followyourclick_tpu.config import (
    CLIPTextConfig,
    MotionModuleConfig,
    NoiseScheduleConfig,
    UNet3DConfig,
)
from followyourclick_tpu.models.clip_text import CLIPTextModel as JCLIP
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.schedulers import ddim as jddim
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.schedulers import ddim as tddim
from followyourclick_tpu_torch.training import step as ts
from followyourclick_tpu_torch.utils.convert import (
    export_jax_params,
    flax_paths,
    load_jax_params,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_unet import random_tree

# the JAX package re-exports the train_step function over its module
jts = importlib.import_module("followyourclick_tpu.training.train_step")

JAX_DTYPES = {None: None, torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16}
B, F, HW = 2, 4, 16
LR = 1e-3
EPS = 1e-5
UPDATE_TOL = 1e-3
TEXT = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2)
UNET = UNet3DConfig(
    down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
    up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
    block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
    cross_attention_dim=TEXT.hidden_size,
    motion_module=MotionModuleConfig(num_attention_heads=4))


@functools.lru_cache(maxsize=None)
def models():
    """The JAX modules and random trees, and the port's modules loaded
    from them (fp32, CPU)."""
    junet, jtext = JUNet(UNET), JCLIP(TEXT)
    cond = JCond(context=jnp.zeros((B, 77, TEXT.hidden_size)),
                 fps=jnp.zeros((B,)), motion_score=jnp.zeros((B,)))
    uparams = random_tree(junet.init, jnp.zeros((B, F, HW, HW, 9)),
                          jnp.zeros((B,), jnp.int32), cond, seed=1)
    tparams = random_tree(jtext.init, jnp.zeros((1, 77), jnp.int32), seed=2)
    unet = load_jax_params(UNet3DConditionModel(UNET), uparams)
    text = load_jax_params(CLIPTextModel(TEXT), tparams)
    return junet, jtext, uparams, tparams, unet, text


def make_batch(seed=0):
    """numpy batch fields."""
    rs = np.random.RandomState(seed)
    return dict(
        latents=rs.randn(B, F, HW, HW, 4).astype(np.float32),
        input_ids=rs.randint(0, TEXT.vocab_size, (B, 77)),
        mask=(rs.rand(B, HW, HW, 1) > 0.5).astype(np.float32),
        fps=np.array([8.0, 12.0], np.float32),
        motion_score=np.array([20.0, 35.0], np.float32))


def jax_draws(key, shape, cfg):
    """The JAX step's draws (``_prepare_step_inputs``) as the port's
    ``StepDraws``."""
    b, f, h, w, _ = shape
    k_t, k_noise, k_rate, k_corrupt = jax.random.split(key, 4)
    return ts.StepDraws(
        torch.tensor(np.asarray(jax.random.randint(k_t, (b,), 0, 1000))),
        torch.tensor(np.asarray(jax.random.normal(k_noise, shape))),
        torch.tensor(np.asarray(jax.random.randint(
            k_rate, (b,), 0, len(cfg.mask_corruption_rates)))),
        torch.tensor(np.asarray(jax.random.uniform(
            k_corrupt, (b, h, w, 1)))))


def jax_config(cfg: ts.TrainConfig):
    return jts.TrainConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


def run_both(cfg, partitioned, frozen_dtype=None, steps=2, seed=0):
    """Two steps of the JAX step and the port's from the same parameters
    and draws; returns (JAX metrics, JAX params, port metrics, port state,
    port module)."""
    junet, jtext, uparams, tparams, unet, text = models()
    jcfg = jax_config(cfg)
    nb = make_batch(seed)
    jbatch = jts.TrainBatch(**{k: jnp.asarray(v) for k, v in nb.items()})
    tbatch = ts.TrainBatch(**{k: torch.from_numpy(v) for k, v in nb.items()})
    jsched = jddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    tsched = tddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    if partitioned:
        jstate = jts.create_partitioned_train_state(
            uparams, jcfg, frozen_dtype=JAX_DTYPES[frozen_dtype])
        tstate = ts.create_partitioned_train_state(
            unet, cfg, frozen_dtype=frozen_dtype)
        jfn, tfn = jts.train_step_partitioned, ts.train_step_partitioned
    else:
        jstate = jts.create_train_state(uparams, jcfg)
        tstate = ts.create_train_state(unet, cfg)
        jfn, tfn = jts.train_step, ts.train_step
    jstep = jax.jit(functools.partial(
        jfn, unet=junet, text_encoder=jtext, text_params=tparams,
        sched=jsched, cfg=jcfg))
    jm, tm = [], []
    for i in range(steps):
        key = jax.random.PRNGKey(10 + i)
        jstate, m = jstep(jstate, jbatch, key)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tfn(tstate, tbatch, None, unet=unet, text_encoder=text,
                        sched=tsched, cfg=cfg,
                        draws=jax_draws(key, nb["latents"].shape, cfg))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, jstate, tm, tstate, unet


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def check(jm, jstate, tm, tstate, unet, cfg, steps=2):
    jparams = jstate.params
    for a, b in zip(jm, tm):
        for k in ("loss", "grad_norm"):
            assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k]), (k, a, b)
    params = tstate.params
    got = flat(export_jax_params(unet, params, like=jparams))
    want = flat(jparams)
    assert got.keys() == want.keys()
    bound = steps * UPDATE_TOL * cfg.learning_rate
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= bound, (worst, bound)
    init = flat(models()[2])
    lrs = tstate.tx.lrs
    paths = flax_paths(unet)
    moved = [n for n in params
             if np.abs(got[paths[n]] - init[paths[n]]).max() > 0]
    assert sorted(moved) == sorted(lrs), "exactly the trainable leaves move"
    for n in params:
        if n not in lrs:
            np.testing.assert_array_equal(got[paths[n]], init[paths[n]])
    return worst


def test_full_tree_step_matches_jax():
    cfg = ts.TrainConfig(learning_rate=LR, adam_eps=EPS, max_grad_norm=1e6,
                         gradient_checkpointing=False)
    check(*run_both(cfg, partitioned=False), cfg)


def test_bf16_frozen_leaves_stay_bf16():
    """The production layout: frozen leaves bf16 and untouched, masters
    fp32, the step's forward in bf16."""
    _, _, _, _, unet, text = models()
    cfg = ts.TrainConfig(learning_rate=LR)
    state = ts.create_partitioned_train_state(unet, cfg)
    before = {n: t.clone() for n, t in state.frozen.items()}
    nb = make_batch()
    batch = ts.TrainBatch(**{k: torch.from_numpy(v) for k, v in nb.items()})
    sched = tddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    gen = torch.Generator().manual_seed(0)
    state, m = ts.train_step_partitioned(state, batch, gen, unet=unet,
                                         text_encoder=text, sched=sched,
                                         cfg=cfg)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert {t.dtype for t in state.frozen.values()} == {torch.bfloat16}
    assert {t.dtype for t in state.trainable.values()} == {torch.float32}
    for n, t in state.frozen.items():
        assert torch.equal(t, before[n])


def test_add_noise_and_velocity_every_timestep():
    """The training range: all 1000 timesteps of the zero-SNR v-prediction
    schedule, against the JAX functions at 1e-5."""
    rs = np.random.RandomState(3)
    x0, eps = (rs.randn(1000, 2, 3, 4).astype(np.float32) for _ in range(2))
    steps = np.arange(1000)
    js = jddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    tsch = tddim.DDIMSchedule.create(NoiseScheduleConfig(), 25)
    for tf, jf in ((tddim.add_noise, jddim.add_noise),
                   (tddim.get_velocity, jddim.get_velocity)):
        got = tf(tsch, torch.from_numpy(x0), torch.from_numpy(eps),
                 torch.from_numpy(steps)).numpy()
        want = np.asarray(jf(js, jnp.asarray(x0), jnp.asarray(eps),
                             jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
