"""The port's first-frame T2I pipeline (``pipelines/text_to_image.py``)
against the JAX ``TextToImagePipeline``, and its sharing of the video
UNet's tensors.

Tiny configs (``tests/test_torch_unet.py``), fp32 on the CPU, 64², CFG 8,
3 DDIM steps: the video UNet's parameters (9-channel ``conv_in``) go to
both, which cut ``conv_in`` to its first 4 input channels and run the UNet
with the motion modules, fps embeddings and click-mask concat off at one
frame. The JAX initial noise (``jax.random.normal(PRNGKey(seed))``) is
injected. The image holds 1e-3 absolute on [0, 1], as the video sampler
does. The port's T2I UNet holds no tensor of its own: every parameter is
the video UNet's (``data_ptr`` equal; ``conv_in`` a view of its first 4
channels).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig as JInference
from followyourclick_tpu.pipelines.text_to_image import (
    TextToImagePipeline as JT2I,
)
from followyourclick_tpu_torch.pipelines.text_to_image import (
    TextToImagePipeline,
    slice_conv_in,
)
from tests.test_torch_pipeline_call import port_pipeline
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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from followyourclick_tpu_torch.utils.native_tokenizer import (
        NativeCLIPTokenizer,
    )

    d = tmp_path_factory.mktemp("vocab")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n")
    (d / "vocab.json").write_text(json.dumps(_vocab(MERGES)))
    hf = transformers.CLIPTokenizer(vocab_file=str(d / "vocab.json"),
                                    merges_file=str(d / "merges.txt"))
    trees = dict(unet=tiny_unet_tree(), vae=tiny_vae_tree(),
                 text_encoder=tiny_clip_tree())
    video = port_pipeline(trees, NativeCLIPTokenizer(str(d / "merges.txt")))
    return hf, trees, video


def test_t2i_matches_jax(setup):
    hf, trees, video = setup
    prompts, seed, steps = ["the cat", "a dog eating"], 7, 3
    jt2i = JT2I(CFG, trees["unet"], trees["vae"], trees["text_encoder"],
                tokenizer=hf)
    want = jt2i(prompts, negative_prompt="ugly", height=64, width=64,
                steps=steps, guidance_scale=8.0, seed=seed)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                       (2, 1, 8, 8, 4), dtype=jnp.float32))
    t2i = TextToImagePipeline(video.config, video.unet, video.vae,
                              video.text_encoder, tokenizer=video.tokenizer)
    got = t2i(prompts, negative_prompt="ugly", height=64, width=64,
              steps=steps, guidance_scale=8.0, seed=seed,
              noise=torch.from_numpy(noise))
    assert isinstance(got, np.ndarray) and got.shape == want.shape \
        == (2, 64, 64, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    again = t2i(prompts[:1], height=64, width=64, steps=1, seed=3)
    assert again.shape == (1, 64, 64, 3) and np.isfinite(again).all()


def test_t2i_shares_the_video_unet_tensors(setup):
    _, _, video = setup
    before = {n: p.data_ptr() for n, p in video.unet.named_parameters()}
    t2i = TextToImagePipeline(video.config, video.unet, video.vae,
                              video.text_encoder)
    assert not t2i.unet.config.use_motion_module
    assert not t2i.unet.config.use_fps_condition
    video_params = dict(video.unet.named_parameters())
    n = 0
    for name, p in t2i.unet.named_parameters():
        assert p.device.type == "cpu", name
        assert p.data_ptr() == video_params[name].data_ptr(), name
        n += 1
    assert n < len(video_params)  # no motion modules, no fps embeddings
    w = t2i.unet.conv_in.conv.weight
    assert w.shape[1] == 4 and video.unet.conv_in.conv.weight.shape[1] == 9
    assert torch.equal(w, video.unet.conv_in.conv.weight[:, :4])
    assert {n: p.data_ptr() for n, p in video.unet.named_parameters()} \
        == before
    assert t2i.vae is video.vae and t2i.text_encoder is video.text_encoder
    sliced = slice_conv_in({"conv_in.conv.weight": torch.zeros(8, 9, 3, 3),
                            "conv_in.conv.bias": torch.zeros(8)})
    assert sliced["conv_in.conv.weight"].shape == (8, 4, 3, 3)
    assert sliced["conv_in.conv.bias"].shape == (8,)
