"""The Follow-Your-Click sampler on the exact path.

Port of ``followyourclick_tpu/pipelines/animation.py``: CLIP text encode
([uncond; cond]), the DDIM v-prediction CFG denoise over the UNet3D with the
click mask and the first-frame latent concatenated on the channel axis, and
one batched VAE decode. PyTorch runs the loop eagerly; the parameters live in
the modules. ``sample`` is the counterpart of ``_sample_jit``.

Only the exact default ``SampleSpec`` is ported: any field off its default
raises ``NotImplementedError``, except ``video_length``, ``height``,
``width``, ``num_inference_steps`` and ``guidance_scale`` (> 1). The
tokenizer needs vocabulary files the repository does not ship, so requests
carry token ids.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_step

VAE_SCALE = 0.18215

_FREE_FIELDS = ("video_length", "height", "width", "num_inference_steps",
                "guidance_scale")


@dataclass(frozen=True)
class SampleSpec:
    """The JAX package's ``SampleSpec`` with the same fields and defaults."""

    video_length: int = 16
    height: int = 512
    width: int = 512
    num_inference_steps: int = 25
    guidance_scale: float = 8.0
    video_scale: float = 0.0
    use_interpolate_noise: bool = True
    use_first_image_as_init_latents: bool = False
    init_alpha_k: float = 64.0
    use_residual_noise: bool = False
    base_lambda: float = 0.9
    eta: float = 0.0
    scheduler: str = "ddim"
    share_cfg_prefix: bool = True
    cfg_cache_interval: int = 1
    pab_spatial_interval: int = 1
    pab_cross_interval: int = 1
    pab_temporal_interval: int = 1
    deep_cache_interval: int = 1
    pab_warmup_steps: int = 0
    cfg_final_exact_steps: int = 2
    cfg_cache_extrapolate: bool = False
    deep_cache_extrapolate: bool = False

    def check_exact_path(self) -> None:
        default = SampleSpec()
        for f in dataclasses.fields(self):
            if f.name in _FREE_FIELDS:
                continue
            if getattr(self, f.name) != getattr(default, f.name):
                raise NotImplementedError(
                    f"SampleSpec.{f.name}={getattr(self, f.name)!r}: only the "
                    "exact default sampler is ported")
        if self.guidance_scale <= 1.0:
            raise NotImplementedError("guidance_scale <= 1 (no CFG)")


class AnimationPipeline:
    """Text encoder, UNet3D and VAE on one device, in one dtype."""

    def __init__(self, config: InferenceConfig,
                 unet: Optional[UNet3DConditionModel] = None,
                 vae: Optional[AutoencoderKL] = None,
                 text_encoder: Optional[CLIPTextModel] = None,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32):
        self.config = config
        self.device = torch.device(device)
        self.dtype = dtype

        def place(m):
            return m.to(device=self.device, dtype=dtype).eval()

        self.unet = place(unet or UNet3DConditionModel(config.unet))
        self.vae = place(vae or AutoencoderKL(config.vae))
        self.text_encoder = place(text_encoder
                                  or CLIPTextModel(config.clip_text))

    def _on(self, x, dtype=None):
        if x is None:
            return None
        return torch.as_tensor(x).to(self.device, dtype)

    def encode_prompt(self, input_ids: torch.Tensor,
                      neg_input_ids: torch.Tensor) -> torch.Tensor:
        """CFG context ``[uncond; cond]`` on the batch axis."""
        cond, _ = self.text_encoder(self._on(input_ids))
        uncond, _ = self.text_encoder(self._on(neg_input_ids))
        return torch.cat([uncond, cond], dim=0)

    def encode_image(self, image: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """image (B, H, W, 3) in [-1, 1] → scaled latent (B, H/8, W/8, 4);
        the distribution mean unless a generator is given."""
        mean, logvar = self.vae.encode(self._on(image, self.dtype))
        if generator is not None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=generator.device, dtype=torch.float32)
            mean = mean + torch.exp(0.5 * logvar) * eps.to(mean)
        return mean * VAE_SCALE

    def prepare_latents(self, batch: int, spec: SampleSpec,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None,
                        init_latents: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Initial latents (B, F, h, w, 4) from standard-normal ``noise``
        (drawn from ``generator`` unless given): interpolated noise
        (frame 0's noise on every frame), init-latent alpha decay, residual
        noise."""
        f, h, w = spec.video_length, spec.height // 8, spec.width // 8
        shape = (batch, f, h, w, 4)
        if noise is None:
            gdev = generator.device if generator is not None else self.device
            noise = torch.randn(shape, generator=generator, device=gdev,
                                dtype=torch.float32)
        latents = self._on(noise, torch.float32)
        if tuple(latents.shape) != shape:
            raise ValueError(f"noise {tuple(latents.shape)}, expected {shape}")
        if spec.use_interpolate_noise:
            latents = latents[:, :1].expand(shape)
        if spec.use_first_image_as_init_latents and init_latents is not None:
            i = torch.arange(f, dtype=torch.float32, device=self.device)
            alpha = ((f - i) / f / spec.init_alpha_k)[None, :, None, None,
                                                      None]
            latents = (self._on(init_latents, torch.float32)[:, None] * alpha
                       + latents * (1 - alpha))
        if spec.use_residual_noise:
            base = latents[:, :1].expand(shape)
            mixed = (spec.base_lambda ** 0.5) * base \
                + ((1 - spec.base_lambda) ** 0.5) * latents
            latents = torch.cat([base[:, :1], mixed[:, 1:]], dim=1)
        return latents.to(self.dtype).contiguous()

    def denoise(self, latents: torch.Tensor, context: torch.Tensor,
                spec: SampleSpec, first_image_latents: torch.Tensor,
                mask: Optional[torch.Tensor], fps: torch.Tensor,
                motion_score: torch.Tensor) -> torch.Tensor:
        """The CFG DDIM loop with CFG prefix sharing: the UNet gets the
        un-duplicated latents with the doubled context and duplicates at its
        first cross-attention."""
        b, f, h, w, _ = latents.shape
        dt = latents.dtype
        sched = DDIMSchedule.create(self.config.noise_scheduler,
                                    spec.num_inference_steps)
        ffl = self._on(first_image_latents, dt)
        first_block = torch.zeros(b, f, h, w, 4, device=self.device,
                                  dtype=dt)
        first_block[:, 0] = ffl
        if mask is not None:
            mask_block = self._on(mask, dt).clamp(0.0, 1.0)[:, None].expand(
                b, f, h, w, 1)
        else:
            mask_block = torch.zeros(b, f, h, w, 1, device=self.device,
                                     dtype=dt)
            mask_block[:, 0] = 1.0
        cond_channels = torch.cat([mask_block, first_block], dim=-1)
        cond = UNetConditioning(context=context,
                                fps=self._on(fps, torch.float32),
                                motion_score=self._on(motion_score,
                                                      torch.float32))
        for i in range(spec.num_inference_steps):
            t = sched.timesteps[i].to(self.device).expand(b)
            x = torch.cat([latents, cond_channels], dim=-1)
            uncond, text = self.unet(x, t, cond).chunk(2, dim=0)
            noise_pred = uncond + spec.guidance_scale * (text - uncond)
            latents, _ = ddim_step(sched, noise_pred, i, latents)
        return latents

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, F, h, w, 4) → video (B, F, H, W, 3) fp32 in [0, 1], all
        frames decoded as one batch."""
        b, f = latents.shape[:2]
        z = latents.to(self.dtype) / VAE_SCALE
        img = self.vae.decode(z.reshape(b * f, *z.shape[2:]))
        video = img.reshape(b, f, *img.shape[1:])
        return (video / 2.0 + 0.5).clamp(0.0, 1.0).float()

    @torch.inference_mode()
    def sample(self, input_ids: torch.Tensor, neg_input_ids: torch.Tensor,
               first_image_latents: torch.Tensor, mask: torch.Tensor,
               fps: torch.Tensor, motion_score: torch.Tensor,
               spec: SampleSpec = SampleSpec(),
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token ids (B, 77) + first-frame latent (B, h, w, 4) + click mask
        (B, h, w, 1) + fps and motion score (B,) → video (B, F, H, W, 3).
        ``noise`` (B, F, h, w, 4) replaces the draw from ``generator``."""
        spec.check_exact_path()
        context = self.encode_prompt(input_ids, neg_input_ids)
        latents = self.prepare_latents(int(input_ids.shape[0]), spec,
                                       generator=generator, noise=noise)
        latents = self.denoise(latents, context, spec, first_image_latents,
                               mask, fps, motion_score)
        return self.decode_latents(latents)
