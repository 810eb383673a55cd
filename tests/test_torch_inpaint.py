"""The port's SD inpainting (``pipelines/inpaint.py``) and
``utils/diffusion_utils.py`` against the JAX package's, fp32 on the CPU.

One tiny JAX ``InpaintPipeline`` (a 2-level motion-free UNet, so a latent
grid need only be even: 64² and 80x112 images; a 4-level VAE, a 2-layer
CLIP at width 64) and the port's on the same seeded weights (``random_tree``
shapes, loaded by ``load_jax_params``); the port is handed JAX's initial
noise (``jax.random.normal`` of the key ``_sample`` splits from the seed).
``sample``: 1e-3 on the [0, 1] image. ``__call__`` at 80x112 (not a
multiple of 64): uint8 outputs within 1 (the float output is truncated,
so 1e-3 may cross an integer), equal outside the mask. The port's pipeline
holds no tensor of its own. ``ddim_inversion_step`` (ε and v, the
``t < 0`` step included) and ``slerp`` (both branches): 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu import config as jconfig
from followyourclick_tpu.models.clip_text import CLIPTextModel as JCLIP
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.models.vae import AutoencoderKL as JVAE
from followyourclick_tpu.pipelines.inpaint import InpaintPipeline as JInpaint
from followyourclick_tpu.schedulers.ddim import DDIMSchedule as JSchedule
from followyourclick_tpu.utils import diffusion_utils as jdu
from followyourclick_tpu_torch import config as pconfig
from followyourclick_tpu_torch.cli.inpaint import HashTokenizer
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.inpaint import (
    InpaintPipeline,
    inpaint_unet_config,
)
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
from followyourclick_tpu_torch.utils import diffusion_utils as du
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_unet import random_tree

STEPS = 3
ATOL = 1e-3


def tiny_configs(module, vae_width=32):
    """The same tiny ``InferenceConfig`` from the JAX or the port's config
    module: a 2-level UNet with attention on its inner level only (motion
    on, as a video UNet's config; the pipelines turn it off), a 4-level
    VAE ``vae_width`` wide, CLIP at width 64."""
    return module.InferenceConfig(
        unet=module.UNet3DConfig(
            down_block_types=("DownBlock3D", "CrossAttnDownBlock3D"),
            up_block_types=("CrossAttnUpBlock3D", "UpBlock3D"),
            block_out_channels=(32, 64), layers_per_block=1,
            norm_num_groups=8, cross_attention_dim=64,
            attention_head_dim=4,
            motion_module=module.MotionModuleConfig(num_attention_heads=4)),
        vae=module.VAEConfig(block_out_channels=(vae_width,) * 4,
                             layers_per_block=1, norm_num_groups=8),
        clip_text=module.CLIPTextConfig(vocab_size=1000, hidden_size=64,
                                        intermediate_size=128,
                                        num_hidden_layers=2,
                                        num_attention_heads=4))


def tiny_trees(jcfg, seed=0):
    """Seeded flax trees of the inpaint UNet, the VAE and CLIP."""
    ucfg = dataclasses.replace(
        jcfg.unet, use_motion_module=False,
        use_first_frame_mask_condition_concat=False,
        use_first_frame_condition_concat=False, use_fps_condition=False)
    cond = JCond(context=jnp.zeros((2, 77, jcfg.clip_text.hidden_size)))
    return {
        "unet": random_tree(JUNet(ucfg).init, jnp.zeros((2, 1, 8, 8, 4)),
                            jnp.zeros((2,), jnp.int32), cond, seed=seed),
        "vae": random_tree(JVAE(jcfg.vae).init, jnp.zeros((1, 64, 64, 3)),
                           jax.random.PRNGKey(0), seed=seed + 1),
        "text_encoder": random_tree(JCLIP(jcfg.clip_text).init,
                                    jnp.zeros((1, 77), jnp.int32),
                                    seed=seed + 2),
    }


def port_inpaint(pcfg, trees, tokenizer=None):
    unet = load_jax_params(UNet3DConditionModel(inpaint_unet_config(pcfg)),
                           trees["unet"])
    vae = load_jax_params(AutoencoderKL(pcfg.vae), trees["vae"])
    text = load_jax_params(CLIPTextModel(pcfg.clip_text),
                           trees["text_encoder"])
    return InpaintPipeline(pcfg, unet, vae, text, tokenizer=tokenizer,
                           device="cpu")


def jax_noise(seed, shape):
    """The initial noise ``InpaintPipeline._sample`` draws for ``seed``."""
    _, noise_rng = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(jax.random.normal(
        noise_rng, shape, jnp.float32)))


@pytest.fixture(scope="module")
def pipelines():
    jcfg, pcfg = tiny_configs(jconfig), tiny_configs(pconfig)
    trees = tiny_trees(jcfg)
    tok = HashTokenizer()
    return (JInpaint(jcfg, trees["unet"], trees["vae"],
                     trees["text_encoder"], tokenizer=tok),
            port_inpaint(pcfg, trees, tok))


def test_sample_matches_jax(pipelines):
    jpipe, pipe = pipelines
    rs = np.random.RandomState(0)
    image = rs.rand(2, 64, 64, 3).astype(np.float32)
    mask = (rs.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    ids = HashTokenizer()(["a red ball", "a cat"]).input_ids
    neg = HashTokenizer()(["", "ugly"]).input_ids
    seed = 4
    want = np.asarray(jpipe._sample(
        jpipe.params, jnp.asarray(image), jnp.asarray(mask),
        (jnp.asarray(ids), jnp.asarray(neg)), seed, STEPS, 7.5))
    got = pipe.sample(torch.from_numpy(image), torch.from_numpy(mask),
                      torch.from_numpy(ids), torch.from_numpy(neg), STEPS,
                      7.5, noise=jax_noise(seed, (2, 8, 8, 4)))
    assert tuple(got.shape) == want.shape == (2, 64, 64, 3)
    assert got.dtype == torch.float32 and got.std() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_call_at_a_size_not_a_multiple_of_64(pipelines):
    jpipe, pipe = pipelines
    h, w, seed = 80, 112, 2
    rs = np.random.RandomState(1)
    img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[20:61, 30:90] = 255
    want = jpipe(img, mask, "a red ball", steps=STEPS, seed=seed)
    got = pipe(img, mask, "a red ball", steps=STEPS, seed=seed,
               noise=jax_noise(seed, (1, h // 8, w // 8, 4)))
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.array_equal(got[mask == 0], img[mask == 0])
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got[mask > 0] != img[mask > 0]).any()
    # the port's own noise: a torch generator on the pipeline's device
    again = pipe(img, mask, "a red ball", steps=1, seed=seed)
    assert again.shape == img.shape


def test_pipeline_holds_no_tensor_of_its_own():
    pcfg = tiny_configs(pconfig)
    video = UNet3DConditionModel(dataclasses.replace(
        pcfg.unet, use_fps_condition=True,
        use_first_frame_mask_condition_concat=True))
    pipe = InpaintPipeline(pcfg, video, None, None, device="cpu")
    assert not pipe.unet.config.use_motion_module
    assert UNet3DConditionModel.conv_in_channels(pipe.unet.config) == 4
    params = dict(video.named_parameters())
    for name, p in pipe.unet.named_parameters():
        assert p.data_ptr() == params[name].data_ptr(), name
    assert pipe.unet.conv_in.conv.weight.shape[1] == 4
    assert video.conv_in.conv.weight.shape[1] == 9


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddim_inversion_step(prediction):
    cfg_kw = dict(prediction_type=prediction)
    jsched = JSchedule.create(jconfig.NoiseScheduleConfig(**cfg_kw), 10)
    sched = DDIMSchedule.create(pconfig.NoiseScheduleConfig(**cfg_kw), 10)
    rs = np.random.RandomState(3)
    for i in (0, 1, 5, 9):  # 0: t < 0, the final alpha
        x = rs.randn(2, 4, 6, 4).astype(np.float32)
        out = rs.randn(2, 4, 6, 4).astype(np.float32)
        want = jdu.ddim_inversion_step(jsched, jnp.asarray(out),
                                       jnp.asarray(i), jnp.asarray(x))
        got = du.ddim_inversion_step(sched, torch.from_numpy(out), i,
                                     torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("branch", ["slerp", "lerp"])
def test_slerp(branch):
    rs = np.random.RandomState(4)
    v0 = rs.randn(3, 8, 8, 4).astype(np.float32)
    v1 = rs.randn(3, 8, 8, 4).astype(np.float32)
    if branch == "lerp":
        v1 = (v0 * 1.5 + 1e-3 * v1).astype(np.float32)
    for t in (0.0, 0.3, 0.75):
        want = jdu.slerp(jnp.asarray(v0), jnp.asarray(v1), t)
        got = du.slerp(torch.from_numpy(v0), torch.from_numpy(v1), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    u0, u1 = v0 / np.linalg.norm(v0), v1 / np.linalg.norm(v1)
    assert (abs(float((u0 * u1).sum())) > 0.9995) == (branch == "lerp")

