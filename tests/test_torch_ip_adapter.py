"""The port's IP-Adapter image-prompt path against the JAX package.

Modules at tiny widths (the CLIP vision tower of tests/test_pipeline_wiring
``TINY_VISION``: 2 layers of 32, 32² images in 16² patches; a 2-layer
Resampler of 64; the tiny UNet of tests/test_torch_unet.py with
``use_ip_cross_attention``), random parameters from a numpy seed in the JAX
modules' flax trees, crossed by ``load_jax_params``, which must leave no
leaf over. fp32 on the CPU. Each module, the ip-enabled UNet included,
holds 1e-4 of its largest output: only the order of fp32 sums differs.

Whole requests (4 frames, 64², CFG 8) against the JAX ``_sample_jit`` with
``ip_pixel_values``: the same token ids, latents, mask, fps, motion score,
image prompt and initial noise; the video holds 1e-3, the port's exact-path
tolerance (tests/test_torch_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig
from followyourclick_tpu.models import attention as jatt
from followyourclick_tpu.models import ip_adapter as jip
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.pipelines import serving_schedules as jss
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu_torch.models import ip_adapter as tip
from followyourclick_tpu_torch.models.attention import CrossAttention
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
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
    tiny_unet_tree,
    tiny_vae_tree,
)

REL = 1e-4
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, image_size=32, patch_size=16,
              projection_dim=1024)
RESAMPLER = dict(dim=64, depth=2, dim_head=16, heads=4, num_queries=8,
                 embedding_dim=48, output_dim=32, ff_mult=2)
IP_TOKENS = 4
IP_UNET = dataclasses.replace(TINY_UNET, use_ip_cross_attention=True,
                              ip_num_tokens=IP_TOKENS)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, (err, rel)


def _images(seed, b=2):
    return np.random.RandomState(seed).randn(
        b, VISION["image_size"], VISION["image_size"], 3).astype(np.float32)


def ip_tree(plus, seed=3):
    module = jip.IPAdapter(jip.CLIPVisionConfig(**VISION), 768, IP_TOKENS,
                           plus)
    return random_tree(module.init, jnp.zeros((1, 32, 32, 3)), seed=seed)


def test_vision_config_is_the_jax_one():
    assert dataclasses.asdict(tip.CLIPVisionConfig()) == dataclasses.asdict(
        jip.CLIPVisionConfig())


def test_clip_vision_matches_jax():
    jm = jip.CLIPVisionModel(jip.CLIPVisionConfig(**VISION))
    x = _images(0)
    tree = random_tree(jm.init, jnp.zeros((1, 32, 32, 3)), seed=1)
    want = jm.apply({"params": tree}, jnp.asarray(x))
    model = load_jax_params(tip.CLIPVisionModel(tip.CLIPVisionConfig(
        **VISION)), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_image_proj_matches_jax():
    jm = jip.ImageProjModel(cross_attention_dim=32, num_tokens=4)
    x = np.random.RandomState(1).randn(3, 48).astype(np.float32)
    tree = random_tree(jm.init, jnp.zeros((1, 48)), seed=2)
    model = load_jax_params(tip.ImageProjModel(48, 32, 4), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, jm.apply({"params": tree}, jnp.asarray(x)))


def test_resampler_matches_jax():
    jm = jip.Resampler(**RESAMPLER)
    x = np.random.RandomState(2).randn(2, 10, 48).astype(np.float32)
    tree = random_tree(jm.init, jnp.zeros((1, 10, 48)), seed=4)
    model = load_jax_params(tip.Resampler(**RESAMPLER), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8, 32)
    _close(got, jm.apply({"params": tree}, jnp.asarray(x)))


@pytest.mark.parametrize("plus", [False, True], ids=["vanilla", "plus"])
def test_ip_adapter_matches_jax(plus):
    """Both variants, with their uncond tokens: the projection of a zero
    embedding (vanilla) or of a black image's features (Plus)."""
    tree = ip_tree(plus)
    x = _images(5)
    want = jip.IPAdapter(jip.CLIPVisionConfig(**VISION), 768, IP_TOKENS,
                         plus).apply({"params": tree}, jnp.asarray(x))
    model = load_jax_params(tip.IPAdapter(tip.CLIPVisionConfig(**VISION),
                                          768, IP_TOKENS, plus), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == (2, IP_TOKENS, 768)
        _close(g.numpy(), w)


@pytest.mark.parametrize("ip_scale", [1.0, 0.6])
def test_cross_attention_with_ip_tokens_matches_jax(ip_scale):
    """The last 4 context tokens go through to_k_ip / to_v_ip; with ip on
    both attentions run at scale = ip_scale (the upstream quirk), which at
    0.6 differs from dim_head**-0.5 = 0.35."""
    kw = dict(query_dim=32, heads=4, dim_head=8, cross_attention_dim=48)
    jm = jatt.CrossAttention(**kw, ip_num_tokens=4, ip_scale=ip_scale)
    rs = np.random.RandomState(6)
    h = rs.randn(2, 20, 32).astype(np.float32)
    ctx = rs.randn(2, 13, 48).astype(np.float32)
    tree = random_tree(jm.init, jnp.zeros((1, 20, 32)),
                       jnp.zeros((1, 13, 48)), seed=7)
    assert {"to_k_ip", "to_v_ip"} <= set(tree)
    model = load_jax_params(CrossAttention(32, 4, 8, 48, 4, ip_scale), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(h), torch.from_numpy(ctx)).numpy()
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(h),
                               jnp.asarray(ctx)))
    _close(got, want)


@pytest.fixture(scope="module")
def ip_unet_tree():
    return tiny_unet_tree(dataclasses.replace(IP_UNET, ip_scale=0.75),
                          seed=8)


def test_ip_unet_matches_jax(ip_unet_tree):
    """One CFG evaluation (sample at B, context [uncond; cond] at 2B with 77
    text and 4 ip tokens), ip_scale 0.75."""
    cfg = dataclasses.replace(IP_UNET, ip_scale=0.75)
    rs = np.random.RandomState(9)
    x = rs.randn(1, 4, 8, 8, 9).astype(np.float32)
    ctx = rs.randn(2, 77 + IP_TOKENS, 768).astype(np.float32)
    t = np.array([601])
    fps, ms = np.full((1,), 8.0, np.float32), np.full((1,), 20.0, np.float32)
    want = jax.jit(JUNet(cfg).apply)(
        {"params": ip_unet_tree}, jnp.asarray(x), jnp.asarray(t),
        JCond(context=jnp.asarray(ctx), fps=jnp.asarray(fps),
              motion_score=jnp.asarray(ms)))
    unet = load_jax_params(UNet3DConditionModel(cfg), ip_unet_tree)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   UNetConditioning(torch.from_numpy(ctx),
                                    torch.from_numpy(fps),
                                    torch.from_numpy(ms)))
    assert got.shape == (2, 4, 8, 8, 4)
    _close(got.numpy(), want)


def test_bridge_fills_every_ip_leaf(ip_unet_tree):
    """load_jax_params raises on a leaf left over or a parameter left
    unfilled: the ip UNet (with to_k_ip / to_v_ip on every attn2) and both
    IPAdapter variants (the Resampler's single-segment layers_{i}_* names,
    the raw class_embedding and latents) cross whole."""
    cfg = dataclasses.replace(IP_UNET, ip_scale=0.75)
    pairs = [(UNet3DConditionModel(cfg), ip_unet_tree)]
    for plus in (False, True):
        pairs.append((tip.IPAdapter(tip.CLIPVisionConfig(**VISION), 768,
                                    IP_TOKENS, plus), ip_tree(plus)))
    for module, tree in pairs:
        load_jax_params(module, tree)
        assert len(jax.tree_util.tree_leaves(tree)) == len(
            list(module.parameters()))
    names = [name for name, _ in pairs[0][0].named_parameters()]
    n_ip = sum(name.endswith(("attn2.to_k_ip.weight", "attn2.to_v_ip.weight"))
               for name in names)
    assert n_ip == 2 * sum(name.endswith("attn2.to_q.weight")
                           for name in names) > 0
    with pytest.raises(ValueError):
        load_jax_params(UNet3DConditionModel(TINY_UNET), ip_unet_tree)


CFG = InferenceConfig(unet=IP_UNET, vae=TINY_VAE, clip_text=TINY_CLIP)


def sample_both(spec_kw, b, plus, seed=0):
    """One tiny IP request of ``b`` clips through the JAX ``_sample_jit``
    and the port's ``sample`` (the JAX initial noise injected), as numpy."""
    trees = dict(unet=tiny_unet_tree(IP_UNET), vae=tiny_vae_tree(),
                 text_encoder=tiny_clip_tree(), ip=ip_tree(plus))
    req = _request(seed, b)
    pixels = _images(seed + 11, b)
    key = jax.random.PRNGKey(7)
    jpipe = JPipeline(CFG, trees["unet"], trees["vae"], trees["text_encoder"],
                      ip_adapter_params=trees["ip"], ip_plus=plus,
                      ip_vision_config=jip.CLIPVisionConfig(**VISION))
    want = np.asarray(jpipe._sample_jit(
        jpipe.params, jnp.asarray(req["input_ids"]),
        jnp.asarray(req["neg_input_ids"]), key, JSpec(**spec_kw),
        first_image_latents=jnp.asarray(req["first_image_latents"]),
        mask=jnp.asarray(req["mask"]), fps=jnp.asarray(req["fps"]),
        motion_score=jnp.asarray(req["motion_score"]),
        ip_pixel_values=jnp.asarray(pixels)))
    noise = np.asarray(jax.random.normal(key, (b, F, H // 8, W // 8, 4)))

    pipe = AnimationPipeline(
        CFG,
        unet=load_jax_params(UNet3DConditionModel(CFG.unet), trees["unet"]),
        vae=load_jax_params(AutoencoderKL(CFG.vae), trees["vae"]),
        text_encoder=load_jax_params(CLIPTextModel(CFG.clip_text),
                                     trees["text_encoder"]),
        device="cpu",
        ip_adapter=load_jax_params(tip.IPAdapter(
            tip.CLIPVisionConfig(**VISION), 768, IP_TOKENS, plus),
            trees["ip"]))
    got = pipe.sample(**{k: torch.from_numpy(np.asarray(v))
                         for k, v in req.items()},
                      spec=SampleSpec(**spec_kw), noise=torch.tensor(noise),
                      ip_pixel_values=torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (b, F, H, W, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    return got, want


@pytest.mark.parametrize("spec_kw,b,plus", [
    (EXACT, 1, True),
    (EXACT, 2, False),
    ({**EXACT, "num_inference_steps": 10,
      **jss.SCHEDULES["pab244_deep4_cfg4_ex"]}, 1, False),
], ids=["exact-plus", "exact-2clips-vanilla", "pab244_deep4_cfg4_ex-vanilla"])
def test_tiny_ip_request_matches_jax(spec_kw, b, plus):
    """The serving schedule's cond-half steps slice ``context[b:]`` with the
    ip tokens included, as the JAX sampler does."""
    got, want = sample_both(spec_kw, b, plus)
    if b == 2:
        assert np.abs(got[0] - got[1]).mean() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_sample_without_an_image_raises():
    pipe = AnimationPipeline.__new__(AnimationPipeline)
    pipe.config = CFG
    ids = torch.zeros(1, 77, dtype=torch.long)
    with pytest.raises(ValueError, match="ip_pixel_values"):
        pipe.sample(ids, ids, None, None, None, None,
                    spec=SampleSpec(**EXACT))
    pipe.ip_adapter = None
    with pytest.raises(ValueError, match="IP-Adapter"):
        pipe.encode_image_prompt(torch.zeros(1, 32, 32, 3))
