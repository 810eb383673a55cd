"""Text-to-image: the first frame for a manifest row that has no image.

Port of ``followyourclick_tpu/pipelines/text_to_image.py`` (the reference
spins up a base Stable Diffusion pipeline, ``scripts/inference.py:
194-204``). The video UNet runs as a 2D SD UNet: the same parameter
tensors, with the motion modules, the fps / motion-score embeddings, the
click-mask concat and the IP path off, at one frame. The motion-free UNet
is built on the meta device and takes the video UNet's tensors by
``load_state_dict(..., assign=True)``, ``conv_in``'s weight as its first 4
input channels (a view), so no second copy of the weights exists. CFG on
the doubled batch, DDIM, then the VAE decode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.pipelines.animation import VAE_SCALE
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_step
from followyourclick_tpu_torch.utils.backend_flags import checked_precision


def slice_conv_in(unet_state: dict, in_channels: int = 4) -> dict:
    """A video UNet's state dict → the T2I UNet's: every ``conv_in`` weight
    cut back to its first ``in_channels`` input channels (the inverse of
    the 2D → 3D inflation; channels 0..3 hold the 2D conv). The cut is a
    view of the same storage."""
    out = dict(unet_state)
    for k, v in unet_state.items():
        if k.startswith("conv_in.") and k.endswith("weight") \
                and v.ndim >= 2 and v.shape[1] > in_channels:
            out[k] = v[:, :in_channels]
    return out


class TextToImagePipeline:
    """Stable Diffusion text → image on the video pipeline's modules.

    ``unet``, ``vae`` and ``text_encoder`` are the video pipeline's (placed
    on their device and dtype already); the T2I UNet shares ``unet``'s
    parameter tensors."""

    def __init__(self, config: InferenceConfig, unet: UNet3DConditionModel,
                 vae, text_encoder, tokenizer=None):
        ucfg = dataclasses.replace(
            config.unet, use_motion_module=False,
            use_first_frame_mask_condition_concat=False,
            use_first_frame_condition_concat=False,
            use_fps_condition=False, use_ip_cross_attention=False)
        with torch.device("meta"):
            t2i_unet = UNet3DConditionModel(ucfg)
        video_state = slice_conv_in(unet.state_dict(),
                                    UNet3DConditionModel.conv_in_channels(
                                        ucfg))
        t2i_unet.load_state_dict(
            {k: video_state[k] for k in t2i_unet.state_dict()},
            strict=True, assign=True)
        self.config = config
        self.unet = t2i_unet.eval()
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        param = next(unet.parameters())
        self.device, self.dtype = param.device, param.dtype

    @torch.inference_mode()
    @checked_precision()
    def sample(self, input_ids: torch.Tensor, neg_ids: torch.Tensor,
               height: int, width: int, steps: int,
               guidance_scale: float = 7.5,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token ids (B, 77) → images (B, H, W, 3) fp32 in [0, 1]. The
        initial latents (B, 1, H/8, W/8, 4) are ``noise`` or a draw from
        ``generator``."""
        dev = self.device
        cond_ctx, _ = self.text_encoder(input_ids.to(dev))
        uncond_ctx, _ = self.text_encoder(neg_ids.to(dev))
        context = torch.cat([uncond_ctx, cond_ctx], dim=0).to(self.dtype)
        b = input_ids.shape[0]
        shape = (b, 1, height // 8, width // 8, 4)
        if noise is None:
            gdev = generator.device if generator is not None else dev
            noise = torch.randn(shape, generator=generator, device=gdev,
                                dtype=torch.float32)
        latents = noise.to(dev, torch.float32)
        if tuple(latents.shape) != shape:
            raise ValueError(f"noise {tuple(latents.shape)}, expected {shape}")
        sched = DDIMSchedule.create(self.config.noise_scheduler, steps)
        cond = UNetConditioning(context=context)
        for i in range(steps):
            x = torch.cat([latents, latents], dim=0).to(self.dtype)
            t = sched.timesteps[i].to(dev).expand(2 * b)
            pred = self.unet(x, t, cond)
            u, c = pred.chunk(2, dim=0)
            latents, _ = ddim_step(sched, u + guidance_scale * (c - u), i,
                                   latents)
        img = self.vae.decode((latents[:, 0] / VAE_SCALE).to(self.dtype))
        return (img / 2 + 0.5).clamp(0.0, 1.0).float()

    @checked_precision()
    def __call__(self, prompt: Sequence[str] | str,
                 negative_prompt: Optional[Sequence[str] | str] = None,
                 height: int = 512, width: int = 512, steps: int = 25,
                 guidance_scale: float = 7.5, seed: int = 0,
                 noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """Prompts → images (B, H, W, 3) float32 in [0, 1], as numpy; the
        noise from a ``torch.Generator`` on the pipeline's device seeded
        with ``seed`` unless ``noise`` is given."""
        if isinstance(prompt, str):
            prompt = [prompt]
        if negative_prompt is None:
            negative_prompt = [""] * len(prompt)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        if self.tokenizer is None:
            raise ValueError("pipeline built without tokenizer")
        enc = self.tokenizer(list(prompt), padding="max_length",
                             max_length=77, truncation=True,
                             return_tensors="np")
        neg = self.tokenizer(list(negative_prompt), padding="max_length",
                             max_length=77, truncation=True,
                             return_tensors="np")
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        img = self.sample(torch.from_numpy(np.asarray(enc.input_ids)),
                          torch.from_numpy(np.asarray(neg.input_ids)),
                          height, width, steps, guidance_scale,
                          generator=generator, noise=noise)
        return img.cpu().numpy()
