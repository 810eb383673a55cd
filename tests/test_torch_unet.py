"""Port parity: UNet3DConditionModel, the CLIP text encoder and the VAE at the
tiny configs of tests/_oracle.py (UNet widths (32, 64, 64, 64), one layer
per block, 8 groups, 4 motion heads; 2-layer CLIP; tiny VAE).

Random parameters (numpy, from a seed, in the JAX modules' flax trees) cross
by ``load_jax_params``, which must leave no leaf unused. No layer is zero, so
the motion modules and the fps / motion-score embeddings reach the output. fp32 on the CPU; the UNet holds
5e-4 (rtol and atol) over ~60 chained layers whose sums are taken in
another order, CLIP and the VAE 2e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import (
    CLIPTextConfig,
    MotionModuleConfig,
    UNet3DConfig,
    VAEConfig,
)
from followyourclick_tpu.models.clip_text import CLIPTextModel as JCLIP
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.models.vae import AutoencoderKL as JVAE
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TINY_UNET = UNet3DConfig(
    sample_size=32, cross_attention_dim=768, attention_head_dim=8,
    block_out_channels=(32, 64, 64, 64), layers_per_block=1,
    norm_num_groups=8,
    motion_module=MotionModuleConfig(num_attention_heads=4,
                                     zero_initialize=False),
    use_fps_condition=True, use_first_frame_mask_condition_concat=True)
TINY_CLIP = CLIPTextConfig(vocab_size=1000, hidden_size=768,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                     norm_num_groups=8, sample_size=64)


def random_tree(init, *args, seed=0):
    """Random parameters in the module's flax tree: the shapes come from
    tracing ``init`` (no compile), the values from a numpy seed. Kernels are
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05²), biases and embeddings
    small normals, so no layer is zero (the JAX init zeroes motion-module
    ``proj_out`` and the fps / motion-score embedding outputs, which would
    keep the motion modules and embeddings from reaching the output)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rs.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.05 * z
        return 0.02 * z  # bias, embedding

    return jax.tree_util.tree_map_with_path(fill, shapes)


# the tiny UNet with the camera-motion embedding (BASELINE config 4)
TINY_CAMERA = dataclasses.replace(TINY_UNET, use_camera_motion_condition=True)


def fresh_copies(build):
    """``build`` traced once a process for each argument list (the trace of
    a UNet's ``init`` takes seconds and the suite asks for the same trees
    many times); each call gets its own copy of every array."""
    cached = functools.lru_cache(maxsize=None)(build)

    @functools.wraps(build)
    def call(*args, **kwargs):
        return jax.tree_util.tree_map(np.array, cached(*args, **kwargs))

    return call


@fresh_copies
def tiny_unet_tree(cfg=TINY_UNET, seed=0):
    """The UNet's random tree; with ``use_camera_motion_condition`` the JAX
    init is given a camera-motion type, so the tree holds that embedding."""
    b, f, hw = 1, 4, 8
    cam = (jnp.full((b,), 1.0) if cfg.use_camera_motion_condition
           else None)
    cond = JCond(context=jnp.zeros((2 * b, 77, 768)),
                 fps=jnp.full((b,), 8.0), motion_score=jnp.full((b,), 20.0),
                 camera_motion_type=cam)
    return random_tree(JUNet(cfg).init,
                       jnp.zeros((b, f, hw, hw, cfg.conv_in_channels)),
                       jnp.zeros((b,), jnp.int32), cond, seed=seed)


@fresh_copies
def tiny_clip_tree(seed=1):
    return random_tree(JCLIP(TINY_CLIP).init, jnp.zeros((1, 77), jnp.int32),
                       seed=seed)


@fresh_copies
def tiny_vae_tree(seed=2):
    return random_tree(JVAE(TINY_VAE).init, jnp.zeros((1, 64, 64, 3)),
                       jax.random.PRNGKey(0), seed=seed)


@pytest.fixture(scope="module")
def unet_tree():
    return tiny_unet_tree()


@pytest.mark.parametrize("cfg_batch", [1, 2])
def test_unet3d(unet_tree, cfg_batch):
    """cfg_batch=2: the exact path's CFG prefix sharing (sample at B, context
    at 2B); fps / motion score at B."""
    tree = unet_tree
    rs = np.random.RandomState(cfg_batch)
    b, f, hw = 1, 4, 8
    x = rs.randn(b, f, hw, hw, 9).astype(np.float32)
    ctx = rs.randn(cfg_batch * b, 77, 768).astype(np.float32)
    tsteps = np.array([801] * b)
    fps, ms = np.full((b,), 8.0, np.float32), np.full((b,), 20.0, np.float32)
    want = jax.jit(JUNet(TINY_UNET).apply)(
        {"params": tree}, jnp.asarray(x), jnp.asarray(tsteps),
        JCond(context=jnp.asarray(ctx), fps=jnp.asarray(fps),
              motion_score=jnp.asarray(ms)))
    unet = load_jax_params(UNet3DConditionModel(TINY_UNET), tree)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(tsteps),
                   UNetConditioning(torch.from_numpy(ctx),
                                    torch.from_numpy(fps),
                                    torch.from_numpy(ms)))
    assert got.shape == (cfg_batch * b, f, hw, hw, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


def test_bridge_fills_every_leaf_at_the_tiny_configs(unet_tree):
    """load_jax_params raises on a leaf left unused or a parameter left
    unfilled; all three tiny trees cross whole."""
    for module, tree in ((UNet3DConditionModel(TINY_UNET), unet_tree),
                         (CLIPTextModel(TINY_CLIP), tiny_clip_tree()),
                         (AutoencoderKL(TINY_VAE), tiny_vae_tree())):
        n_leaves = len(jax.tree_util.tree_leaves(tree))
        load_jax_params(module, tree)
        assert n_leaves == len(list(module.parameters()))


@pytest.mark.parametrize("cfg_batch", [1, 2])
def test_camera_motion_embedding(cfg_batch):
    """The camera-motion embedding (zero-init output, here random) added
    before the fps and motion embeddings, its type given at the sample's
    (pre-CFG) batch and tiled to the doubled one. Two clips alike in all
    but their camera types (pan_left, zoom_in) must give different
    predictions. The bridge carries its leaves with the rest."""
    tree = tiny_unet_tree(TINY_CAMERA)
    assert "camera_motion_embedding" in tree
    unet = UNet3DConditionModel(TINY_CAMERA)
    load_jax_params(unet, tree)
    assert len(jax.tree_util.tree_leaves(tree)) == len(list(
        unet.parameters()))
    rs = np.random.RandomState(5 + cfg_batch)
    b, f, hw = 2, 4, 8
    x = np.repeat(rs.randn(1, f, hw, hw, 9).astype(np.float32), b, axis=0)
    ctx = np.repeat(rs.randn(cfg_batch, 1, 77, 768).astype(np.float32), b,
                    axis=1).reshape(cfg_batch * b, 77, 768)
    tsteps = np.array([501] * b)
    fps, ms = np.full((b,), 8.0, np.float32), np.full((b,), 20.0, np.float32)
    cam = np.array([0.0, 4.0], np.float32)
    want = jax.jit(JUNet(TINY_CAMERA).apply)(
        {"params": tree}, jnp.asarray(x), jnp.asarray(tsteps),
        JCond(context=jnp.asarray(ctx), fps=jnp.asarray(fps),
              motion_score=jnp.asarray(ms),
              camera_motion_type=jnp.asarray(cam)))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(tsteps),
                   UNetConditioning(torch.from_numpy(ctx),
                                    torch.from_numpy(fps),
                                    torch.from_numpy(ms),
                                    torch.from_numpy(cam)))
    assert got.shape == (cfg_batch * b, f, hw, hw, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_unet3d_rejects_unported_options():
    """The two options the JAX UNet declares but never reads still raise;
    every other option builds (tests/test_torch_unet_options*.py)."""
    for bad in (dict(resnet_time_scale_shift="scale_shift"),
                dict(class_embed_type="timestep")):
        with pytest.raises(NotImplementedError):
            UNet3DConditionModel(dataclasses.replace(TINY_UNET, **bad))


def test_clip_text():
    tree = tiny_clip_tree()
    ids = np.random.RandomState(3).randint(0, 1000, size=(2, 77))
    want, want_pooled = jax.jit(JCLIP(TINY_CLIP).apply)({"params": tree},
                                                        jnp.asarray(ids))
    model = load_jax_params(CLIPTextModel(TINY_CLIP), tree)
    with torch.no_grad():
        got, pooled = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               rtol=2e-4, atol=2e-4)


def test_vae_encode_decode():
    tree = tiny_vae_tree()
    rs = np.random.RandomState(4)
    img = rs.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    z = rs.randn(3, 8, 8, 4).astype(np.float32)
    jv = JVAE(TINY_VAE)
    jmean, jlogvar = jax.jit(lambda p, x: jv.apply(p, x, method=jv.encode))(
        {"params": tree}, jnp.asarray(img))
    jdec = jax.jit(lambda p, x: jv.apply(p, x, method=jv.decode))(
        {"params": tree}, jnp.asarray(z))
    vae = load_jax_params(AutoencoderKL(TINY_VAE), tree)
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(img))
        dec = vae.decode(torch.from_numpy(z))
    for got, want in ((mean, jmean), (logvar, jlogvar), (dec, jdec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
