"""The port's prompt-level ``AnimationPipeline.__call__`` against the JAX
``__call__``.

Tiny configs (``tests/test_torch_unet.py``), fp32 on the CPU, 4 frames at
64². The JAX pipeline tokenizes with ``transformers.CLIPTokenizer`` (its
first choice), the port with its own tokenizer, both over the same
synthetic ``merges.txt`` / ``vocab.json``; the prompts, negative prompts,
first-frame latents, click mask, fps and motion score are the same, and
the JAX initial noise (``jax.random.normal(PRNGKey(seed))``, what
``_sample_jit`` draws with ``eta = 0``) is injected through ``noise=``,
since the two PRNGs differ. The video holds 1e-3 absolute on [0, 1], as
``tests/test_torch_pipeline.py``: the exact sampler at 2 steps and
``pab244_deep4_cfg4_ex`` at 6 (one period of 4 and the 2 final exact
steps). ``__call__`` raises where JAX asserts or raises: no tokenizer, T5
weights without a T5 tokenizer, an IP UNet without an ``ip_image``; with a
T5 tokenizer given (a word-hash stand-in: the repository ships no
sentencepiece model) it tokenizes for T5 through ``tokenize_2``.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig as JInference
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu.pipelines.serving_schedules import SCHEDULES
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.t5_text import T5Config, T5EncoderModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    SampleSpec,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from followyourclick_tpu_torch.utils.native_tokenizer import (
    NativeCLIPTokenizer,
)
from tests.test_torch_tokenizer import (  # noqa: F401 (fixture)
    MERGES,
    _vocab,
    one_torch_thread,
)
from tests.test_torch_unet import (
    TINY_CLIP,
    TINY_UNET,
    TINY_VAE,
    tiny_clip_tree,
    tiny_unet_tree,
    tiny_vae_tree,
)

CFG = JInference(unet=TINY_UNET, vae=TINY_VAE, clip_text=TINY_CLIP)
F, H, W = 4, 64, 64
PROMPTS = ["the cat dogging", "a dog eating the cat"]
NEGS = ["ugly", ""]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("vocab")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n")
    (d / "vocab.json").write_text(json.dumps(_vocab(MERGES)))
    return (transformers.CLIPTokenizer(vocab_file=str(d / "vocab.json"),
                                       merges_file=str(d / "merges.txt")),
            NativeCLIPTokenizer(str(d / "merges.txt")))


@pytest.fixture(scope="module")
def trees():
    return dict(unet=tiny_unet_tree(), vae=tiny_vae_tree(),
                text_encoder=tiny_clip_tree())


def port_pipeline(trees, tokenizer, cfg=CFG, **kw):
    return AnimationPipeline(
        cfg,
        unet=load_jax_params(UNet3DConditionModel(cfg.unet), trees["unet"]),
        vae=load_jax_params(AutoencoderKL(cfg.vae), trees["vae"]),
        text_encoder=load_jax_params(CLIPTextModel(cfg.clip_text),
                                     trees["text_encoder"]),
        device="cpu", tokenizer=tokenizer, **kw)


class WordHashTokenizer:
    """T5-shaped ids and padding masks: a word's id is the sum of its
    bytes modulo 50, 1 (eos) closes the prompt, 0 pads."""

    def __call__(self, texts, padding=None, max_length=77, truncation=True,
                 return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for r, text in enumerate(texts):
            words = [sum(w.encode()) % 50 for w in
                     text.split()][:max_length - 1] + [1]
            ids[r, :len(words)] = words
            mask[r, :len(words)] = 1
        return types.SimpleNamespace(input_ids=ids, attention_mask=mask)


def _conditioning(b, seed=5):
    rs = np.random.RandomState(seed)
    first = rs.randn(b, H // 8, W // 8, 4).astype(np.float32)
    mask = (rs.rand(b, H // 8, W // 8, 1) > 0.5).astype(np.float32)
    return first, mask


@pytest.mark.parametrize("spec_kw", [
    dict(num_inference_steps=2),
    dict(num_inference_steps=6, **SCHEDULES["pab244_deep4_cfg4_ex"])],
    ids=["exact", "pab244_deep4_cfg4_ex"])
def test_call_matches_jax(trees, tokenizers, spec_kw):
    hf, port_tok = tokenizers
    spec_kw = dict(video_length=F, height=H, width=W, guidance_scale=8.0,
                   **spec_kw)
    b, seed = len(PROMPTS), 11
    first, mask = _conditioning(b)
    jpipe = JPipeline(CFG, trees["unet"], trees["vae"],
                      trees["text_encoder"], tokenizer=hf)
    want = jpipe(PROMPTS, negative_prompt=NEGS, spec=JSpec(**spec_kw),
                 first_image_latents=jnp.asarray(first),
                 mask=jnp.asarray(mask), fps=8.0, motion_score=20.0,
                 seed=seed)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                         (b, F, H // 8, W // 8, 4)))
    pipe = port_pipeline(trees, port_tok)
    got = pipe(PROMPTS, negative_prompt=NEGS, spec=SampleSpec(**spec_kw),
               first_image_latents=first, mask=mask, fps=8.0,
               motion_score=20.0, seed=seed, noise=torch.tensor(noise))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (b, F, H, W, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert np.abs(got[0] - got[1]).mean() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_call_tokenizes_as_transformers_and_seeds_noise(trees, tokenizers):
    """``tokenize`` gives ``CLIPTokenizer``'s ids (empty negatives where
    None); a seed gives the same video twice and another seed another."""
    hf, port_tok = tokenizers
    pipe = port_pipeline(trees, port_tok)
    ids, neg = pipe.tokenize(PROMPTS)
    np.testing.assert_array_equal(
        ids, hf(PROMPTS, padding="max_length", max_length=77,
                truncation=True, return_tensors="np").input_ids)
    np.testing.assert_array_equal(
        neg, hf([""] * 2, padding="max_length", max_length=77,
                truncation=True, return_tensors="np").input_ids)
    spec = SampleSpec(video_length=2, height=H, width=W,
                      num_inference_steps=1)
    first, mask = _conditioning(1)
    runs = [pipe("the cat", spec=spec, first_image_latents=first, mask=mask,
                 seed=s) for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.abs(runs[0] - runs[2]).mean() > 1e-4


def test_call_raises_where_jax_does(trees, tokenizers):
    _, port_tok = tokenizers
    spec = SampleSpec(video_length=2, height=H, width=W,
                      num_inference_steps=1)
    first, mask = _conditioning(1)
    with pytest.raises(ValueError, match="without tokenizer"):
        port_pipeline(trees, None)("the cat", spec=spec,
                                   first_image_latents=first, mask=mask)
    t5_cfg = dataclasses.replace(CFG, unet=dataclasses.replace(
        TINY_UNET, use_text_encoder_2=True, text_encoder_2_dim=16))
    t5_unet = UNet3DConditionModel(t5_cfg.unet)
    t5 = T5EncoderModel(T5Config(vocab_size=50, d_model=16, d_kv=4, d_ff=24,
                                 num_layers=1, num_heads=2))
    pipe = AnimationPipeline(t5_cfg, unet=t5_unet, device="cpu", t5=t5,
                             tokenizer=port_tok)
    with pytest.raises(ValueError, match="T5 tokenizer"):
        pipe("the cat", spec=spec, first_image_latents=first, mask=mask)
    pipe.tokenizer_2 = WordHashTokenizer()
    ids, m, nids, nm = pipe.tokenize_2(["the cat on the road"], ["ugly"])
    assert ids.shape == m.shape == (1, 77) and m.sum() == 6 and nm.sum() == 2
    video = pipe("the cat", spec=spec, first_image_latents=first, mask=mask)
    assert video.shape == (1, 2, H, W, 3) and np.isfinite(video).all()
    ip_cfg = dataclasses.replace(CFG, unet=dataclasses.replace(
        TINY_UNET, use_ip_cross_attention=True, ip_num_tokens=4))
    pipe = AnimationPipeline(ip_cfg, device="cpu", tokenizer=port_tok)
    with pytest.raises(ValueError, match="ip_image"):
        pipe("the cat", spec=spec, first_image_latents=first, mask=mask)
