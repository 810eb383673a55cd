"""The port's whole tiny sampler against the JAX pipeline, and the port's
independence from JAX.

The JAX ``AnimationPipeline._sample_jit`` and the port's
``AnimationPipeline.sample`` run the same request at the tiny configs
(4 frames, 64², 2 DDIM steps, CFG 8, the default exact ``SampleSpec``):
the same token ids, first-frame latent, click mask, fps and motion score,
the same random parameters (by ``load_jax_params``), and JAX's own initial
noise injected into the port, since the two PRNGs differ. fp32 on the CPU.
The video holds 1e-3 absolute: two UNet calls, the DDIM chain and a VAE
decode amplify the 5e-4 of one UNet call slightly, on outputs in [0, 1].
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    SampleSpec,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_unet import (
    TINY_CLIP,
    TINY_UNET,
    TINY_VAE,
    tiny_clip_tree,
    tiny_unet_tree,
    tiny_vae_tree,
)

CFG = InferenceConfig(unet=TINY_UNET, vae=TINY_VAE, clip_text=TINY_CLIP)
F, H, W, STEPS = 4, 64, 64, 2


def _request(seed):
    rs = np.random.RandomState(seed)
    return dict(
        input_ids=rs.randint(0, 1000, size=(1, 77)),
        neg_input_ids=rs.randint(0, 1000, size=(1, 77)),
        first_image_latents=rs.randn(1, H // 8, W // 8, 4).astype(
            np.float32),
        mask=(rs.rand(1, H // 8, W // 8, 1) > 0.5).astype(np.float32),
        fps=np.full((1,), 8.0, np.float32),
        motion_score=np.full((1,), 20.0, np.float32))


def test_tiny_sample_matches_jax():
    trees = dict(unet=tiny_unet_tree(), vae=tiny_vae_tree(),
                 text_encoder=tiny_clip_tree())
    req = _request(0)
    spec_kw = dict(video_length=F, height=H, width=W,
                   num_inference_steps=STEPS, guidance_scale=8.0)
    key = jax.random.PRNGKey(7)

    jpipe = JPipeline(CFG, trees["unet"], trees["vae"],
                      trees["text_encoder"])
    want = np.asarray(jpipe._sample_jit(
        jpipe.params, jnp.asarray(req["input_ids"]),
        jnp.asarray(req["neg_input_ids"]), key, JSpec(**spec_kw),
        first_image_latents=jnp.asarray(req["first_image_latents"]),
        mask=jnp.asarray(req["mask"]), fps=jnp.asarray(req["fps"]),
        motion_score=jnp.asarray(req["motion_score"])))
    # _sample_jit draws its initial noise from the key itself (eta == 0)
    noise = np.asarray(jax.random.normal(key, (1, F, H // 8, W // 8, 4)))

    pipe = AnimationPipeline(
        CFG,
        unet=load_jax_params(UNet3DConditionModel(CFG.unet), trees["unet"]),
        vae=load_jax_params(AutoencoderKL(CFG.vae), trees["vae"]),
        text_encoder=load_jax_params(CLIPTextModel(CFG.clip_text),
                                     trees["text_encoder"]))
    got = pipe.sample(**{k: torch.from_numpy(np.asarray(v))
                         for k, v in req.items()},
                      spec=SampleSpec(**spec_kw),
                      noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (1, F, H, W, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("field,value", [("video_scale", 1.0),
                                         ("share_cfg_prefix", False),
                                         ("pab_spatial_interval", 2),
                                         ("eta", 0.5),
                                         ("guidance_scale", 1.0)])
def test_sample_rejects_specs_off_the_exact_path(field, value):
    with pytest.raises(NotImplementedError):
        SampleSpec(**{field: value}).check_exact_path()


def test_prepare_latents_interpolates_first_frame_noise():
    pipe = AnimationPipeline.__new__(AnimationPipeline)
    pipe.device, pipe.dtype = torch.device("cpu"), torch.float32
    spec = SampleSpec(video_length=3, height=16, width=16)
    g = torch.Generator().manual_seed(0)
    lat = pipe.prepare_latents(2, spec, generator=g)
    assert lat.shape == (2, 3, 2, 2, 4)
    torch.testing.assert_close(lat[:, 1], lat[:, 0])
    assert not torch.allclose(lat[0], lat[1])


def test_port_runs_without_jax():
    """The port's tiny sampler in a fresh interpreter loads neither jax nor
    flax."""
    code = textwrap.dedent("""
        import sys
        import torch
        from followyourclick_tpu_torch.config import (CLIPTextConfig,
            InferenceConfig, MotionModuleConfig, UNet3DConfig, VAEConfig)
        from followyourclick_tpu_torch.pipelines.animation import (
            AnimationPipeline, SampleSpec)
        torch.manual_seed(0)
        cfg = InferenceConfig(
            unet=UNet3DConfig(block_out_channels=(32, 64, 64, 64),
                              layers_per_block=1, norm_num_groups=8,
                              motion_module=MotionModuleConfig(
                                  num_attention_heads=4)),
            vae=VAEConfig(block_out_channels=(32, 32, 32, 32),
                          layers_per_block=1, norm_num_groups=8),
            clip_text=CLIPTextConfig(vocab_size=1000, intermediate_size=512,
                                     num_hidden_layers=1,
                                     num_attention_heads=4))
        pipe = AnimationPipeline(cfg)
        ids = torch.randint(0, 1000, (1, 77))
        video = pipe.sample(ids, ids, torch.randn(1, 8, 8, 4),
                            torch.ones(1, 8, 8, 1), torch.tensor([8.0]),
                            torch.tensor([20.0]),
                            SampleSpec(video_length=2, height=64, width=64,
                                       num_inference_steps=1),
                            generator=torch.Generator().manual_seed(0))
        assert video.shape == (1, 2, 64, 64, 3), video.shape
        assert bool(torch.isfinite(video).all())
        print("LOADED", sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "flax")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
