"""The UNet under training: the trainable mask at full width against the
JAX one, and per-block checkpointing (``remat_blocks``).

The mask: the JAX ``trainable_mask`` over the flagship ``UNet3DConfig()``
tree (shapes from ``jax.eval_shape``, nothing computed) against the port's,
decided on each parameter's JAX path, on a UNet built on the meta device;
leaf for leaf, and the trainable parameter count. ``remat_blocks``: the
tiny UNet of ``tests/test_torch_training_step.py`` gives the same loss and
gradients, bit for bit, with each block a checkpoint region as without,
and the same output under ``inference_mode``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from followyourclick_tpu.config import UNet3DConfig as JConfig
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu_torch.config import UNet3DConfig
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.training import step as ts
from followyourclick_tpu_torch.utils.convert import flax_paths
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import UNET, models

jts = importlib.import_module("followyourclick_tpu.training.train_step")


def test_full_width_mask_matches_jax():
    b, f, h, w = 1, 2, 8, 8
    junet = JUNet(JConfig())
    cond = JCond(context=jnp.zeros((b, 77, 768)), fps=jnp.zeros((b,)),
                 motion_score=jnp.zeros((b,)))
    shapes = jax.eval_shape(junet.init, jax.random.PRNGKey(0),
                            jnp.zeros((b, f, h, w, 9)),
                            jnp.zeros((b,), jnp.int32), cond)["params"]
    prefixes = tuple(ts.TrainConfig().trainable_modules)
    jmask = jts.trainable_mask(shapes, prefixes)
    leaves = {}

    def walk(mask, tree, path):
        for k, v in mask.items():
            if isinstance(v, dict):
                walk(v, tree[k], path + (k,))
            else:
                leaves[path + (k,)] = (v, int(np.prod(tree[k].shape)))

    walk(jmask, shapes, ())
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig())
    tmask = ts.trainable_mask(unet, prefixes)
    paths = flax_paths(unet)
    assert sorted(paths.values()) == sorted(leaves)
    for name, path in paths.items():
        assert tmask[name] == leaves[path][0], path
    sizes = dict(unet.named_parameters())
    n_port = sum(sizes[n].numel() for n, m in tmask.items() if m)
    n_jax = sum(n for m, n in leaves.values() if m)
    assert n_port == n_jax == 421_264_960


def test_remat_blocks_same_gradients():
    _, _, _, _, unet, _ = models()
    remat = UNet3DConditionModel(UNET, remat_blocks=True)
    remat.load_state_dict(unet.state_dict())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 16, 16, 9).astype(np.float32))
    cond = UNetConditioning(
        context=torch.from_numpy(rs.randn(2, 77, 32).astype(np.float32)),
        fps=torch.tensor([8.0, 12.0]), motion_score=torch.tensor([20., 35.]))
    t = torch.tensor([100, 900])
    grads = []
    for m in (unet, remat):
        m.zero_grad()
        loss = m(x, t, cond).square().mean()
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    with torch.inference_mode():
        assert torch.equal(unet(x, t, cond), remat(x, t, cond))
    unet.zero_grad()
    remat.zero_grad()


def test_remat_blocks_under_functional_call():
    """The train step runs the UNet through ``functional_call`` on the
    state's tensors, and a block's recompute runs in the backward, after
    that call has put the module's own parameters back: the recompute must
    read the state's. With state tensors unlike the module's, the step's
    loss and gradients with ``remat_blocks`` equal those without, bit for
    bit (and the whole-call checkpoint too)."""
    from followyourclick_tpu_torch.config import NoiseScheduleConfig
    from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
    from tests.test_torch_training_step import make_batch

    _, _, _, _, unet, text = models()
    remat = UNet3DConditionModel(UNET, remat_blocks=True)
    remat.load_state_dict(unet.state_dict())
    gen = torch.Generator().manual_seed(0)
    params = {n: p.detach() + 0.05 * torch.randn(p.shape, generator=gen)
              for n, p in unet.named_parameters()}
    batch = ts.TrainBatch(**{k: torch.from_numpy(v)
                             for k, v in make_batch().items()})
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)
    results = []
    for module, whole in ((unet, False), (remat, False), (remat, True)):
        cfg = ts.TrainConfig(gradient_checkpointing=whole)
        state = ts.create_partitioned_train_state(
            module, cfg, frozen_dtype=torch.float32, params=params)
        draws = ts.draw_step(batch.latents, sched, cfg,
                             torch.Generator().manual_seed(1))
        results.append(ts.partitioned_loss_and_grads(
            state, batch, draws, unet=module, text_encoder=text,
            sched=sched, cfg=cfg))
    (loss, grads), *others = results
    for other_loss, other_grads in others:
        assert torch.equal(loss, other_loss)
        for n, g in grads.items():
            assert torch.equal(g, other_grads[n]), n


def test_qkv_cache_follows_the_tensors_in_place():
    """The cached ``[Wq; Wk; Wv]`` is rebuilt whenever a call puts other
    tensors in the weights' place (as a train step's cast, every step),
    though each is new and may reuse a freed one's address."""
    from torch.func import functional_call

    from followyourclick_tpu_torch.models.motion_module import (
        TemporalAttention,
    )

    class Operand(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = TemporalAttention(16, 2, 8)

        def forward(self):
            return self.attn.qkv_weight()

    op = Operand()
    names = [f"attn.to_{p}.weight" for p in "qkv"]
    # each step's weights: new tensor objects over the same memory, at
    # version 0, as an allocator that reuses a freed block gives them
    memory = np.zeros((3, 16, 16), np.float32)
    rs = np.random.RandomState(0)
    for step in range(4):
        memory[:] = rs.randn(3, 16, 16)
        ws = {n: torch.from_numpy(memory[i]) for i, n in enumerate(names)}
        got = functional_call(op, ws, ())
        assert torch.equal(got, torch.from_numpy(memory.reshape(48, 16))), \
            step
    own = op()
    assert own is op() and torch.equal(own, torch.cat(
        [op.attn.to_q.weight, op.attn.to_k.weight, op.attn.to_v.weight]))
