"""The port's tiny sampler with each conditioning option against the JAX
sampler (the harness of ``tests/test_torch_sampler_options.py``: fp32 on
the CPU, JAX's noise injected, the video held to 1e-3 absolute).

- BASELINE config 4: a UNet with the camera-motion embedding and a merged
  camera-motion LoRA (merged into the JAX tree by the JAX merge, into the
  port's modules by the port's), a camera type per request;
- the init image (``use_first_image_as_init_latents``: the first-frame
  latent blended into the noise with a decaying alpha) with residual noise
  and a partial mask on the first-frame latent channels;
- a request of 2 clips under ``video_scale`` with the unshared CFG prefix:
  the per-frame pass's context tiled over 2 clips × 4 frames;
- ``decode_latents(frame_chunk=3)`` on 2 clips of 4 frames: batches of
  3 × 2 frames in (F, B) order, the last padded with the leading frames,
  against the JAX frame-scanned decode and the port's one-batch decode
  (2e-4, the VAE's tolerance in ``tests/test_torch_unet.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.utils.lora import merge_motion_lora as jax_motion
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.animation import AnimationPipeline
from followyourclick_tpu_torch.utils.convert import load_jax_params
from followyourclick_tpu_torch.utils.lora import merge_motion_lora
from tests.test_torch_lora import motion_lora
from tests.test_torch_pipeline import CFG, EXACT, F, H, W
from tests.test_torch_sampler_options import ATOL, sample_both
from tests.test_torch_unet import (
    TINY_CAMERA,
    tiny_clip_tree,
    tiny_unet_tree,
    tiny_vae_tree,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

CAMERA = dataclasses.replace(CFG, unet=TINY_CAMERA)


def test_camera_lora_matches_jax():
    tree = tiny_unet_tree(TINY_CAMERA)
    lora = motion_lora(TINY_CAMERA, seed=4)
    unet = merge_motion_lora(
        load_jax_params(UNet3DConditionModel(TINY_CAMERA), tree), lora)
    got, want = sample_both(EXACT, cfg=CAMERA, camera=[4.0],
                            unet_tree=jax_motion(tree, lora), port_unet=unet)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_init_image_residual_noise_partial_mask_matches_jax():
    got, want = sample_both(
        dict(EXACT, use_first_image_as_init_latents=True,
             use_residual_noise=True), partial=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_two_clip_video_scale_matches_jax():
    got, want = sample_both(dict(EXACT, video_scale=1.5,
                                 share_cfg_prefix=False), b=2)
    assert np.abs(got[0] - got[1]).mean() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_chunked_decode_matches_jax():
    tree = tiny_vae_tree()
    latents = np.random.RandomState(9).randn(2, F, H // 8, W // 8, 4) \
        .astype(np.float32)
    jpipe = JPipeline(CFG, tiny_unet_tree(), tree, tiny_clip_tree())
    want = np.asarray(jax.jit(jpipe.decode_latents, static_argnums=(2,))(
        jpipe.params, jnp.asarray(latents), 3))
    pipe = AnimationPipeline(CFG, vae=load_jax_params(AutoencoderKL(CFG.vae),
                                                      tree), device="cpu")
    with torch.no_grad():
        got = pipe.decode_latents(torch.from_numpy(latents),
                                  frame_chunk=3).numpy()
        whole = pipe.decode_latents(torch.from_numpy(latents)).numpy()
    assert got.shape == (2, F, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, whole, rtol=2e-4, atol=2e-4)
