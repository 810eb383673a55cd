"""The Follow-Your-Click sampler: the exact path and the serving schedules.

Port of ``followyourclick_tpu/pipelines/animation.py``: CLIP text encode
([uncond; cond]), the DDIM v-prediction CFG denoise over the UNet3D with the
click mask and the first-frame latent concatenated on the channel axis, and
one batched VAE decode. PyTorch runs the loop eagerly; the parameters live in
the modules. ``sample`` is the counterpart of ``_sample_jit``.

The serving schedules (``pipelines/serving_schedules.py``) are ported: the
CFG-uncond cache with its first-order forecast, PAB attention reuse and the
DeepCache trunk reuse with its forecast (``models/pab.py``), warm-up steps
and final exact steps. :func:`step_plan` is their static schedule. Every
other field off its default raises ``NotImplementedError``, except
``video_length``, ``height``, ``width``, ``num_inference_steps`` and
``guidance_scale`` (> 1). The tokenizer needs vocabulary files the
repository does not ship, so requests carry token ids.

IP-Adapter image prompts (BASELINE config 3): a pipeline built with an
``ip_adapter`` (``models/ip_adapter.IPAdapter``) over a UNet with
``use_ip_cross_attention`` encodes ``ip_pixel_values`` once per request and
appends the ``[uncond; cond]`` image tokens to the text context on the token
axis, before the denoise; the cond-half steps of a serving schedule then
slice ``context[b:]`` with the ip tokens included.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.ip_adapter import IPAdapter
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_step

VAE_SCALE = 0.18215

_FREE_FIELDS = ("video_length", "height", "width", "num_inference_steps",
                "guidance_scale")
SERVING_FIELDS = ("cfg_cache_interval", "pab_spatial_interval",
                  "pab_cross_interval", "pab_temporal_interval",
                  "deep_cache_interval", "pab_warmup_steps",
                  "cfg_final_exact_steps", "cfg_cache_extrapolate",
                  "deep_cache_extrapolate")


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

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` on a field the port does not run:
        anything off its default but the clip shape, the steps, the
        guidance scale (> 1) and the serving fields."""
        default = SampleSpec()
        for f in dataclasses.fields(self):
            if f.name in _FREE_FIELDS or f.name in SERVING_FIELDS:
                continue
            if getattr(self, f.name) != getattr(default, f.name):
                raise NotImplementedError(
                    f"SampleSpec.{f.name}={getattr(self, f.name)!r}: not "
                    "ported (only the exact sampler and the serving "
                    "schedules are)")
        if self.guidance_scale <= 1.0:
            raise NotImplementedError("guidance_scale <= 1 (no CFG)")


class PlanStep(NamedTuple):
    """One denoise step: DDIM index ``i``, period position ``j``, whether
    the UNet runs on the full CFG batch (else on the cond half, against the
    cached uncond prediction), and the PAB mode (None: no PAB sites)."""

    i: int
    j: int
    full: bool
    mode: Optional[PabMode]


def step_plan(spec: SampleSpec) -> list[PlanStep]:
    """The static schedule of a request (``_denoise_pab`` and the CFG-cache
    branch of the JAX sampler's step).

    Without PAB or trunk reuse, each step is full except, under
    ``cfg_cache_interval`` k > 1, those with ``i % k != 0`` before the last
    ``cfg_final_exact_steps``. With them: ``pab_warmup_steps`` exact steps
    (recording every kind), whole periods of lcm(k, intervals) positions,
    the leftover steps as a prefix of the period, then the final exact steps
    (under k > 1). Position ``j`` reuses a kind whose interval does not divide
    it, and runs on the cond half when k does not divide it."""
    n = spec.num_inference_steps
    cfg_k = max(1, spec.cfg_cache_interval)
    iv = dict(spatial=max(1, spec.pab_spatial_interval),
              cross=max(1, spec.pab_cross_interval),
              temporal=max(1, spec.pab_temporal_interval),
              deep=max(1, spec.deep_cache_interval))
    if all(v == 1 for v in iv.values()):
        fe = spec.cfg_final_exact_steps
        return [PlanStep(i, i % cfg_k, i % cfg_k == 0 or i >= n - fe, None)
                for i in range(n)]
    deep_ex = spec.deep_cache_extrapolate and iv["deep"] > 1
    rec = PabMode(record_spatial=iv["spatial"] > 1,
                  record_cross=iv["cross"] > 1,
                  record_temporal=iv["temporal"] > 1,
                  record_deep=iv["deep"] > 1, deep_extrapolate=deep_ex)

    def at(i: int, j: int) -> PlanStep:
        return PlanStep(i, j, j % cfg_k == 0, dataclasses.replace(
            rec, half=j % cfg_k != 0,
            reuse_spatial=iv["spatial"] > 1 and j % iv["spatial"] != 0,
            reuse_cross=iv["cross"] > 1 and j % iv["cross"] != 0,
            reuse_temporal=iv["temporal"] > 1 and j % iv["temporal"] != 0,
            reuse_deep=iv["deep"] > 1 and j % iv["deep"] != 0,
            deep_ex_coeff=(j % iv["deep"]) / iv["deep"] if deep_ex else 0.0))

    period = math.lcm(cfg_k, *iv.values())
    final_exact = min(max(0, spec.cfg_final_exact_steps), n) \
        if cfg_k > 1 else 0
    warmup = min(max(0, spec.pab_warmup_steps), n - final_exact)
    body = n - warmup - final_exact
    plan = [at(i, 0) for i in range(warmup)]
    plan += [at(warmup + k, k % period) for k in range(body)]
    plan += [at(i, 0) for i in range(warmup + body, n)]
    return plan


class AnimationPipeline:
    """Text encoder, UNet3D, VAE and the optional IP-Adapter on one device,
    in one dtype: the card unless the caller passes ``device="cpu"``."""

    def __init__(self, config: InferenceConfig,
                 unet: Optional[UNet3DConditionModel] = None,
                 vae: Optional[AutoencoderKL] = None,
                 text_encoder: Optional[CLIPTextModel] = None,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32,
                 ip_adapter: Optional[IPAdapter] = None):
        self.config = config
        self.device = torch.device(device)
        self.dtype = dtype

        def place(m):
            return m.to(device=self.device, dtype=dtype).eval()

        self.unet = place(unet or UNet3DConditionModel(config.unet))
        self.vae = place(vae or AutoencoderKL(config.vae))
        self.text_encoder = place(text_encoder
                                  or CLIPTextModel(config.clip_text))
        self.ip_adapter = None if ip_adapter is None else place(ip_adapter)

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

    def encode_image_prompt(self, pixel_values: torch.Tensor
                            ) -> torch.Tensor:
        """CLIP-normalised condition images (B, 224, 224, 3) → the ip
        tokens ``[uncond; cond]`` (2B, N, 768), ready to append to the text
        context on the token axis."""
        if self.ip_adapter is None:
            raise ValueError("pipeline built without an IP-Adapter: pass "
                             "ip_adapter= to use ip_pixel_values")
        cond, uncond = self.ip_adapter(self._on(pixel_values, self.dtype))
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
                spec: SampleSpec, first_image_latents: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], fps: torch.Tensor,
                motion_score: torch.Tensor) -> torch.Tensor:
        """The CFG DDIM loop over :func:`step_plan`.

        Without PAB sites the UNet gets the un-duplicated latents with the
        doubled context and duplicates at its first cross-attention (CFG
        prefix sharing). With them, full steps feed it the pre-duplicated
        input, as the JAX sampler's ``build_x``, and the PAB cache (a dict
        this loop owns) passes down to every site. A step on the cond half
        runs the UNet on the cond rows with the cond context and takes the
        uncond prediction from the last full step, or under
        ``cfg_cache_extrapolate`` its first-order forecast
        ``u1 + (i − i1)·(u1 − u0)/(i1 − i0)`` from the last two.

        The click mask and the first-frame latent reach the UNet as 5
        channels beside the latents only when the UNet has
        ``use_first_frame_mask_condition_concat`` (its 9-channel
        ``conv_in``); otherwise it gets the bare latents, and
        ``first_image_latents`` and ``mask`` are not read."""
        b, f, h, w, _ = latents.shape
        dt = latents.dtype
        sched = DDIMSchedule.create(self.config.noise_scheduler,
                                    spec.num_inference_steps)
        cond_channels = None
        if self.config.unet.use_first_frame_mask_condition_concat:
            if first_image_latents is None:
                raise ValueError(
                    "unet.use_first_frame_mask_condition_concat is on: the "
                    "first-frame latent is required")
            first_block = torch.zeros(b, f, h, w, 4, device=self.device,
                                      dtype=dt)
            first_block[:, 0] = self._on(first_image_latents, dt)
            if mask is not None:
                mask_block = self._on(mask, dt).clamp(0.0, 1.0)[:, None] \
                    .expand(b, f, h, w, 1)
            else:
                mask_block = torch.zeros(b, f, h, w, 1, device=self.device,
                                         dtype=dt)
                mask_block[:, 0] = 1.0
            cond_channels = torch.cat([mask_block, first_block], dim=-1)
        fps = self._on(fps, torch.float32)
        motion_score = self._on(motion_score, torch.float32)
        cond = UNetConditioning(context=context, fps=fps,
                                motion_score=motion_score)
        cond_half = UNetConditioning(context=context[b:], fps=fps,
                                     motion_score=motion_score)
        extrap = spec.cfg_cache_extrapolate and spec.cfg_cache_interval > 1
        cache: dict = {}
        u1 = u0 = None
        i1 = i0 = -1
        for i, _, full, mode in step_plan(spec):
            t = sched.timesteps[i].to(self.device)
            x = latents if cond_channels is None else torch.cat(
                [latents, cond_channels], dim=-1)
            if full and mode is not None:
                x = torch.cat([x, x], dim=0)
            out = self.unet(x, t.expand(x.shape[0]),
                            cond if full else cond_half, mode, cache)
            if full:
                uncond, text = out.chunk(2, dim=0)
                u0, i0 = (uncond, i) if i1 < 0 else (u1, i1)
                u1, i1 = uncond, i
            else:
                text, uncond = out, u1
                if extrap:
                    slope = (i - i1) / max(i1 - i0, 1)
                    uncond = (u1.float() + (u1.float() - u0.float()) * slope
                              ).to(u1.dtype)
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
               first_image_latents: Optional[torch.Tensor],
               mask: Optional[torch.Tensor],
               fps: torch.Tensor, motion_score: torch.Tensor,
               spec: SampleSpec = SampleSpec(),
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               ip_pixel_values: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Token ids (B, 77) + first-frame latent (B, h, w, 4) + click mask
        (B, h, w, 1) + fps and motion score (B,) → video (B, F, H, W, 3).
        ``noise`` (B, F, h, w, 4) replaces the draw from ``generator``;
        ``ip_pixel_values`` (B, 224, 224, 3) is the image prompt, required
        when the UNet has ``use_ip_cross_attention``. The first-frame latent
        and the mask may be None when the UNet has no
        ``use_first_frame_mask_condition_concat``."""
        spec.check_ported()
        if ip_pixel_values is None and \
                self.config.unet.use_ip_cross_attention:
            raise ValueError(
                "unet.use_ip_cross_attention is on: the attention layers "
                "treat the last ip_num_tokens of the context as image tokens, "
                "so ip_pixel_values (CLIP pixel values) are required")
        context = self.encode_prompt(input_ids, neg_input_ids)
        if ip_pixel_values is not None:
            ip_tokens = self.encode_image_prompt(ip_pixel_values)
            context = torch.cat([context, ip_tokens.to(context.dtype)],
                                dim=1)
        latents = self.prepare_latents(int(input_ids.shape[0]), spec,
                                       generator=generator, noise=noise)
        latents = self.denoise(latents, context, spec, first_image_latents,
                               mask, fps, motion_score)
        return self.decode_latents(latents)
