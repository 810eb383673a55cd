"""Stable-Diffusion text-guided inpainting by masked-latent blending.

Port of ``followyourclick_tpu/pipelines/inpaint.py`` (the reference's
``stable_diffusion_inpaint.py`` on the legacy inpaint mechanics: after
every DDIM step the region outside the mask is replaced by the image's
latents noised to the step's timestep, so a plain SD checkpoint inpaints).
The UNet is the video UNet as an SD UNet: motion modules, both click-mask
concats and the fps embedding off, ``conv_in`` at 4 channels, one frame.
Like the T2I pipeline it is built on the meta device and takes the given
UNet's tensors by ``load_state_dict(..., assign=True)`` (``conv_in`` cut
to its first 4 input channels, a view), so no second copy of the weights
exists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.pipelines.animation import VAE_SCALE
from followyourclick_tpu_torch.pipelines.text_to_image import slice_conv_in
from followyourclick_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    add_noise,
    ddim_step,
)
from followyourclick_tpu_torch.utils.backend_flags import checked_precision
from followyourclick_tpu_torch.utils.image_ops import resize_nearest


def inpaint_unet_config(config: InferenceConfig):
    """The inpaint UNet's config: the video UNet's with the motion modules,
    both concat flags and the fps embedding off."""
    return dataclasses.replace(
        config.unet, use_motion_module=False,
        use_first_frame_mask_condition_concat=False,
        use_first_frame_condition_concat=False, use_fps_condition=False)


class InpaintPipeline:
    """image (B, H, W, 3) in [0, 1] + latent-resolution mask (B, h, w, 1),
    1 = repaint, + prompt → the inpainted image.

    ``unet`` (a video UNet or one of :func:`inpaint_unet_config`), ``vae``
    and ``text_encoder`` move to ``device`` (the card unless the caller
    says otherwise) in their own dtype; the pipeline's UNet shares
    ``unet``'s parameter tensors."""

    def __init__(self, config: InferenceConfig, unet: UNet3DConditionModel,
                 vae, text_encoder, tokenizer=None, device="cuda"):
        unet, vae, text_encoder = (m if m is None else m.to(device)
                                   for m in (unet, vae, text_encoder))
        ucfg = inpaint_unet_config(config)
        with torch.device("meta"):
            inpaint_unet = UNet3DConditionModel(ucfg)
        state = slice_conv_in(unet.state_dict(),
                              UNet3DConditionModel.conv_in_channels(ucfg))
        inpaint_unet.load_state_dict(
            {k: state[k] for k in inpaint_unet.state_dict()}, strict=True,
            assign=True)
        self.config = config
        self.unet = inpaint_unet.eval()
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        param = next(unet.parameters())
        self.device, self.dtype = param.device, param.dtype

    @torch.inference_mode()
    @checked_precision()
    def sample(self, image: torch.Tensor, mask: torch.Tensor,
               input_ids: torch.Tensor, neg_ids: torch.Tensor, steps: int,
               guidance_scale: float = 7.5,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1], mask (B, H/8, W/8, 1), token ids (B, 77)
        → (B, H, W, 3) fp32 in [0, 1]. The initial latents (B, H/8, W/8, 4),
        also the noise the kept region is re-noised with, are ``noise`` or
        a draw from ``generator``."""
        dev, dt = self.device, self.dtype
        cond_ctx, _ = self.text_encoder(input_ids.to(dev))
        uncond_ctx, _ = self.text_encoder(neg_ids.to(dev))
        cond = UNetConditioning(context=torch.cat(
            [uncond_ctx, cond_ctx], dim=0).to(dt))
        b = input_ids.shape[0]
        mean, _ = self.vae.encode((image.to(dev) * 2.0 - 1.0).to(dt))
        z0 = (mean * VAE_SCALE).float()
        if noise is None:
            gdev = generator.device if generator is not None else dev
            noise = torch.randn(z0.shape, generator=generator, device=gdev,
                                dtype=torch.float32)
        noise = noise.to(dev, torch.float32)
        if noise.shape != z0.shape:
            raise ValueError(f"noise {tuple(noise.shape)}, expected "
                             f"{tuple(z0.shape)}")
        mask = mask.to(dev, torch.float32)
        sched = DDIMSchedule.create(self.config.noise_scheduler, steps)
        ratio = sched.cfg.num_train_timesteps // steps
        latents = noise  # strength 1: start from pure noise
        for i in range(steps):
            x = torch.cat([latents[:, None]] * 2, dim=0).to(dt)
            t = sched.timesteps[i].to(dev).expand(2 * b)
            u, c = self.unet(x, t, cond)[:, 0].chunk(2, dim=0)
            new, _ = ddim_step(sched, u + guidance_scale * (c - u), i,
                               latents)
            # the kept region: the image's latents noised to the previous
            # timestep, clean after the last step
            prev_t = int(sched.timesteps[i]) - ratio
            init = (add_noise(sched, z0, noise, torch.full(
                (b,), prev_t, device=dev)) if prev_t >= 0 else z0)
            latents = init * (1.0 - mask) + new * mask
        img = self.vae.decode((latents / VAE_SCALE).to(dt))
        return (img / 2 + 0.5).clamp(0.0, 1.0).float()

    @checked_precision()
    def __call__(self, image: np.ndarray, mask: np.ndarray, prompt: str,
                 negative_prompt: str = "", steps: int = 25,
                 guidance_scale: float = 7.5, seed: int = 0,
                 noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """(H, W, 3) uint8 + (H, W) mask ({0, 255} or bool, nonzero =
        repaint) → (H, W, 3) uint8: the output truncated to uint8, then
        pasted under the pixel mask only. The noise comes from a
        ``torch.Generator`` on the pipeline's device seeded with ``seed``
        unless ``noise`` is given."""
        if self.tokenizer is None:
            raise ValueError("pipeline built without tokenizer")
        h, w = image.shape[:2]
        enc = self.tokenizer([prompt], padding="max_length", max_length=77,
                             truncation=True, return_tensors="np")
        neg = self.tokenizer([negative_prompt], padding="max_length",
                             max_length=77, truncation=True,
                             return_tensors="np")
        img = torch.from_numpy(image.astype(np.float32)[None] / 255.0)
        m = (np.asarray(mask) > 0).astype(np.float32)
        m_lat = torch.from_numpy(resize_nearest(m, (w // 8, h // 8)))
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        out = self.sample(img, m_lat[None, ..., None],
                          torch.from_numpy(np.asarray(enc.input_ids)),
                          torch.from_numpy(np.asarray(neg.input_ids)),
                          steps, guidance_scale, generator=generator,
                          noise=noise)
        out = (out[0].cpu().numpy() * 255).astype(np.uint8)
        sel = m > 0
        res = image.copy()
        res[sel] = out[sel]
        return res
