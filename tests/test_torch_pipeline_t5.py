"""The port's tiny sampler with the T5 second text tower, and with the
first-frame latent concatenated in the UNet, against the JAX pipeline.

As in ``tests/test_torch_pipeline.py``: the JAX ``_sample_jit`` and the
port's ``sample`` run one request at the tiny configs (4 frames, 64², CFG 8)
with the same token ids, first-frame latent, click mask, fps and motion
score, the same random parameters (by ``load_jax_params``; every leaf
random, so the zero-initialised T5 projection and ``attn_t5`` outputs move
the video) and JAX's initial noise injected. The T5 request adds a tiny T5
encoder (vocabulary 200, d_model 32, 2 layers) fed T5 token ids and padding
masks, cond and uncond; its states enter every spatial transformer block
through ``attn_t5``. fp32 on the CPU; the video holds 1e-3 absolute, the
tolerance of ``tests/test_torch_pipeline.py``. The exact sampler is here;
``pab244_deep4_cfg4_ex`` (whose cross sites now include ``attn_t5_out``) in
``tests/test_torch_pipeline_t5_serving.py`` and the first-frame concat in
``tests/test_torch_pipeline_concat.py``, one JAX compile a file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig
from followyourclick_tpu.models import t5_text as jt5
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu_torch.models import t5_text as tt5
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    SampleSpec,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_pipeline import EXACT, F, H, W, _request
from tests.test_torch_unet import (
    TINY_CLIP,
    TINY_UNET,
    TINY_VAE,
    random_tree,
    tiny_clip_tree,
    tiny_vae_tree,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

T5 = dict(vocab_size=200, d_model=32, d_kv=8, d_ff=64, num_layers=2,
          num_heads=4)
T5_TOKENS = 20
T5_CFG = InferenceConfig(
    unet=dataclasses.replace(TINY_UNET, use_text_encoder_2=True,
                             text_encoder_2_dim=T5["d_model"]),
    vae=TINY_VAE, clip_text=TINY_CLIP)
# the first-frame latent concatenated over the frames inside the UNet, in
# place of the pipeline's click-mask channels
CONCAT_CFG = InferenceConfig(
    unet=dataclasses.replace(TINY_UNET, use_first_frame_condition_concat=True,
                             use_first_frame_mask_condition_concat=False),
    vae=TINY_VAE, clip_text=TINY_CLIP)


def unet_tree(cfg, seed=0):
    """The UNet's random tree with its T5 projection and ``attn_t5`` (T5
    states given to the init) or its 8-channel ``conv_in`` (a 4-channel
    sample and the reference latent)."""
    b, hw = 1, 8
    c = UNet3DConditionModel.conv_in_channels(cfg)
    cond = dict(context=jnp.zeros((2 * b, 77, 768)), fps=jnp.full((b,), 8.0),
                motion_score=jnp.full((b,), 20.0))
    if cfg.use_text_encoder_2:
        cond["context_t5"] = jnp.zeros((2 * b, T5_TOKENS,
                                        cfg.text_encoder_2_dim))
    if cfg.use_first_frame_condition_concat:
        cond["reference_images_latent"] = jnp.zeros((b, hw, hw, 4))
        c -= 4
    return random_tree(JUNet(cfg).init, jnp.zeros((b, F, hw, hw, c)),
                       jnp.zeros((b,), jnp.int32), JCond(**cond), seed=seed)


def t5_request(seed):
    """T5 token ids and padding masks, cond and uncond: the cond prompt
    fills 14 of 20 tokens, the uncond prompt 3."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, T5["vocab_size"], (2, 1, T5_TOKENS))
    masks = np.zeros((2, 1, T5_TOKENS), np.int64)
    masks[0, :, :14] = 1
    masks[1, :, :3] = 1
    return dict(t5_input_ids=ids[0], t5_attention_mask=masks[0],
                t5_neg_input_ids=ids[1], t5_neg_attention_mask=masks[1])


def sample_both(cfg, spec_kw, seed=0):
    trees = dict(unet=unet_tree(cfg.unet), vae=tiny_vae_tree(),
                 text_encoder=tiny_clip_tree())
    req = _request(seed)
    t5_kw, jt5_model, tt5_model = {}, None, None
    if cfg.unet.use_text_encoder_2:
        t5_kw = t5_request(seed + 1)
        jt5_model = jt5.T5EncoderModel(jt5.T5Config(**T5))
        trees["t5"] = random_tree(
            jt5_model.init, jnp.zeros((1, T5_TOKENS), jnp.int32),
            jnp.ones((1, T5_TOKENS), jnp.int32), seed=3)
        tt5_model = load_jax_params(tt5.T5EncoderModel(tt5.T5Config(**T5)),
                                    trees["t5"])
    if not cfg.unet.use_first_frame_mask_condition_concat:
        req["mask"] = None
    key = jax.random.PRNGKey(7)
    jpipe = JPipeline(cfg, trees["unet"], trees["vae"],
                      trees["text_encoder"], t5_params=trees.get("t5"),
                      t5_config=None if jt5_model is None
                      else jt5.T5Config(**T5))
    want = np.asarray(jpipe._sample_jit(
        jpipe.params, jnp.asarray(req["input_ids"]),
        jnp.asarray(req["neg_input_ids"]), key, JSpec(**spec_kw),
        first_image_latents=jnp.asarray(req["first_image_latents"]),
        mask=None if req["mask"] is None else jnp.asarray(req["mask"]),
        fps=jnp.asarray(req["fps"]),
        motion_score=jnp.asarray(req["motion_score"]),
        **{k: jnp.asarray(v) for k, v in t5_kw.items()}))
    noise = np.asarray(jax.random.normal(key, (1, F, H // 8, W // 8, 4)))
    pipe = AnimationPipeline(
        cfg,
        unet=load_jax_params(UNet3DConditionModel(cfg.unet), trees["unet"]),
        vae=load_jax_params(AutoencoderKL(cfg.vae), trees["vae"]),
        text_encoder=load_jax_params(CLIPTextModel(cfg.clip_text),
                                     trees["text_encoder"]),
        device="cpu", t5=tt5_model)
    got = pipe.sample(**{k: None if v is None else torch.from_numpy(
                            np.asarray(v)) for k, v in req.items()},
                      **{k: torch.from_numpy(v) for k, v in t5_kw.items()},
                      spec=SampleSpec(**spec_kw),
                      noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (1, F, H, W, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    return got, want, pipe, req, t5_kw, noise


def test_tiny_t5_sample_matches_jax():
    got, want, pipe, req, _, noise = sample_both(T5_CFG, EXACT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # the T5 tower reaches the video
    without = pipe.sample(**{k: torch.from_numpy(np.asarray(v))
                             for k, v in req.items()},
                          spec=SampleSpec(**EXACT),
                          noise=torch.tensor(noise)).numpy()
    assert np.abs(without - got).max() > 1e-3


def test_encode_prompt_t5_is_uncond_then_cond():
    """``[uncond; cond]`` on the batch axis, each prompt through the T5
    encoder alone; a pipeline without T5 refuses T5 ids."""
    model = tt5.T5EncoderModel(tt5.T5Config(**T5))
    pipe = AnimationPipeline(T5_CFG, device="cpu", t5=model)
    req = {k: torch.from_numpy(v) for k, v in t5_request(4).items()}
    with torch.no_grad():
        states = pipe.encode_prompt_t5(**{
            "input_ids": req["t5_input_ids"],
            "attention_mask": req["t5_attention_mask"],
            "neg_input_ids": req["t5_neg_input_ids"],
            "neg_attention_mask": req["t5_neg_attention_mask"]})
        cond = model(req["t5_input_ids"], req["t5_attention_mask"])
        uncond = model(req["t5_neg_input_ids"], req["t5_neg_attention_mask"])
    assert states.shape == (2, T5_TOKENS, T5["d_model"])
    torch.testing.assert_close(states, torch.cat([uncond, cond]))
    with pytest.raises(ValueError, match="T5"):
        AnimationPipeline(T5_CFG, device="cpu").encode_prompt_t5(
            *req.values())
