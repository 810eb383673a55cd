"""The Follow-Your-Click sampler: every solver, guidance mode and serving
schedule of the JAX sampler.

Port of ``followyourclick_tpu/pipelines/animation.py``: CLIP text encode
([uncond; cond], the cond rows alone without CFG), the denoise over the
UNet3D with the click mask and the first-frame latent concatenated on the
channel axis, and the VAE decode (one batch, or ``frame_chunk`` frames a
batch). PyTorch runs the loop eagerly; the parameters live in the modules.
``sample`` is the counterpart of ``_sample_jit``.

Every ``SampleSpec`` field is ported: the solvers of
``schedulers/dispatch.SCHEDULERS`` (DDIM with ``eta``, Euler-A with fresh
noise every step, PNDM's PRK grid with more calls than steps), no CFG
(``guidance_scale <= 1``), the duplicated (unshared) CFG prefix, the 3-term
``video_scale`` guidance with its per-frame pass, the init-image and
residual noise, and the serving schedules (``pipelines/serving_schedules.
py``): the CFG-uncond cache with its first-order forecast, PAB attention
reuse and the DeepCache trunk reuse with its forecast (``models/pab.py``),
warm-up steps and final exact steps. :func:`step_plan` is their static
schedule, :func:`request_plan` a request's UNet calls. Only the combinations
the JAX sampler refuses raise (:meth:`SampleSpec.check_ported`).
:meth:`AnimationPipeline.__call__` is the prompt-level entry (the JAX
``__call__``): it tokenizes with the pipeline's CLIP tokenizer
(``utils/native_tokenizer.py``, over an SD directory's ``merges.txt``),
draws the noise from a ``torch.Generator`` seeded on the pipeline's device
and returns the video as numpy.

The T5 second text tower: a pipeline built with a ``t5``
(``models/t5_text.T5EncoderModel``) over a UNet with ``use_text_encoder_2``
encodes the T5 token ids and padding masks of a request once
(:meth:`AnimationPipeline.encode_prompt_t5`, ``[uncond; cond]``); the UNet
projects the states into every spatial transformer's ``attn_t5``, and the
cond-half steps slice them as the CLIP context. A UNet with
``use_first_frame_condition_concat`` gets the first-frame latent as
``reference_images_latent``.

IP-Adapter image prompts (BASELINE config 3): a pipeline built with an
``ip_adapter`` (``models/ip_adapter.IPAdapter``) over a UNet with
``use_ip_cross_attention`` encodes ``ip_pixel_values`` once per request and
appends the ``[uncond; cond]`` image tokens to the text context on the token
axis, before the denoise; the cond-half steps of a serving schedule then
slice ``context[b:]`` with the ip tokens included.

On a ``(data, model)`` mesh (``mesh=``, ``parallel/mesh.create_mesh``), as
the JAX pipeline's ``mesh``: the UNet and the VAE are sharded over
``model`` (``parallel/sharding.shard_params``), CLIP, T5 and the
IP-Adapter encoder stay replicated, and the clips of a request are dealt
over ``data`` (contiguous rows, ``process_shard``'s split). Each data rank
encodes the whole request's prompts, draws every random tensor at the
whole request's shape and keeps its rows, denoises and decodes its clips,
and the videos are gathered over the data ranks, so every rank returns
the whole request's video. The PAB and DeepCache sites cache what the
sharded modules return, which is after their all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.ip_adapter import IPAdapter
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.models.t5_text import T5EncoderModel
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.schedulers.dispatch import (
    SCHEDULERS,
    make_solver,
)
from followyourclick_tpu_torch.utils.backend_flags import checked_precision

VAE_SCALE = 0.18215

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

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    @property
    def pab_on(self) -> bool:
        return (self.pab_spatial_interval > 1 or self.pab_cross_interval > 1
                or self.pab_temporal_interval > 1
                or self.deep_cache_interval > 1)

    @property
    def cfg_cache(self) -> bool:
        """The CFG-uncond cache is on: CFG, no ``video_scale``, k > 1."""
        return (self.do_cfg and self.video_scale == 0
                and self.cfg_cache_interval > 1)

    def check_ported(self) -> None:
        """Raise ``ValueError`` on what the JAX sampler refuses: an unknown
        scheduler, ``eta > 0`` on another solver than DDIM, PAB or the CFG
        cache on another solver than DDIM, PAB with ``video_scale``."""
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"expected one of {SCHEDULERS}")
        if self.eta > 0 and self.scheduler != "ddim":
            raise ValueError("eta is a DDIM knob")
        if (self.pab_on or self.cfg_cache) and self.scheduler != "ddim":
            raise ValueError("the PAB / cfg-cache serving approximations run "
                             "on the DDIM scan only")
        if self.pab_on and self.video_scale != 0:
            raise ValueError("pab_*_interval composes with plain CFG only "
                             "(no video_scale 3-term guidance)")


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


def request_plan(spec: SampleSpec, n_calls: int) -> list[PlanStep]:
    """The UNet calls of a request, in order, for a solver of ``n_calls``
    calls: :func:`step_plan` on DDIM, with the CFG cache off where the JAX
    sampler turns it off (no CFG, ``video_scale``); on the other solvers
    (no serving schedule) ``n_calls`` full steps."""
    if spec.scheduler != "ddim":
        return [PlanStep(i, 0, True, None) for i in range(n_calls)]
    if not (spec.cfg_cache or (spec.pab_on and spec.do_cfg)):
        spec = dataclasses.replace(spec, cfg_cache_interval=1)
    return step_plan(spec)


class AnimationPipeline:
    """Text encoder, UNet3D, VAE and the optional IP-Adapter and T5 encoder
    on one device, in one dtype: the card unless the caller passes
    ``device="cpu"``."""

    def __init__(self, config: InferenceConfig,
                 unet: Optional[UNet3DConditionModel] = None,
                 vae: Optional[AutoencoderKL] = None,
                 text_encoder: Optional[CLIPTextModel] = None,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32,
                 ip_adapter: Optional[IPAdapter] = None,
                 t5: Optional[T5EncoderModel] = None,
                 tokenizer=None, tokenizer_2=None, mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = torch.device(device)
        self.dtype = dtype
        self.tokenizer = tokenizer
        self.tokenizer_2 = tokenizer_2

        def place(m):
            return m.to(device=self.device, dtype=dtype).eval()

        self.unet = place(unet or UNet3DConditionModel(config.unet))
        self.vae = place(vae or AutoencoderKL(config.vae))
        self.text_encoder = place(text_encoder
                                  or CLIPTextModel(config.clip_text))
        self.ip_adapter = None if ip_adapter is None else place(ip_adapter)
        self.t5 = None if t5 is None else place(t5)
        if mesh is not None:
            from followyourclick_tpu_torch.parallel.sharding import (
                shard_params,
            )

            shard_params(self.unet, mesh)
            shard_params(self.vae, mesh)

    def clip_rows(self, batch: int) -> Optional[tuple]:
        """``(start, stop, batch)``: this data rank's clips of a request of
        ``batch`` (contiguous, ``process_shard``'s split); None off a mesh
        with data ranks."""
        mesh = self.mesh
        if mesh is None or mesh.data_size == 1:
            return None
        per = -(-batch // mesh.data_size)
        start = mesh.data_rank * per
        stop = min(start + per, batch)
        if start >= stop:
            raise ValueError(f"a request of {batch} clips leaves data rank "
                             f"{mesh.data_rank} of {mesh.data_size} none")
        return start, stop, batch

    def tokenize(self, prompts: Sequence[str],
                 negative_prompts: Optional[Sequence[str]] = None):
        """CLIP token ids (B, 77) of the prompts and the negative prompts
        (empty strings where None), as numpy."""
        if self.tokenizer is None:
            raise ValueError("pipeline built without tokenizer")
        if negative_prompts is None:
            negative_prompts = [""] * len(prompts)
        enc = self.tokenizer(list(prompts), padding="max_length",
                             max_length=77, truncation=True,
                             return_tensors="np")
        neg = self.tokenizer(list(negative_prompts), padding="max_length",
                             max_length=77, truncation=True,
                             return_tensors="np")
        return np.asarray(enc.input_ids), np.asarray(neg.input_ids)

    def tokenize_2(self, prompts: Sequence[str],
                   negative_prompts: Optional[Sequence[str]] = None,
                   max_length: int = 77):
        """T5 token ids and padding masks of the prompts and the negative
        prompts: ``(ids, mask, neg_ids, neg_mask)``, with ``tokenizer_2``
        (``utils/t5_tokenizer.T5Tokenizer``, which the loader builds from a
        T5 directory's ``tokenizer.json`` or ``spiece.model``)."""
        if self.tokenizer_2 is None:
            raise ValueError("pipeline built without T5 tokenizer "
                             "(tokenizer_2); pass T5 token ids and masks "
                             "to sample()")
        if negative_prompts is None:
            negative_prompts = [""] * len(prompts)
        enc = self.tokenizer_2(list(prompts), padding="max_length",
                               max_length=max_length, truncation=True,
                               return_tensors="np")
        neg = self.tokenizer_2(list(negative_prompts), padding="max_length",
                               max_length=max_length, truncation=True,
                               return_tensors="np")
        return (np.asarray(enc.input_ids), np.asarray(enc.attention_mask),
                np.asarray(neg.input_ids), np.asarray(neg.attention_mask))

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

    def encode_prompt_t5(self, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor,
                         neg_input_ids: torch.Tensor,
                         neg_attention_mask: torch.Tensor) -> torch.Tensor:
        """The raw T5 states ``[uncond; cond]`` (2B, S, d_model), one pass
        each; the UNet projects them."""
        if self.t5 is None:
            raise ValueError("pipeline built without a T5 encoder: pass t5= "
                             "to use t5_input_ids")
        cond = self.t5(self._on(input_ids), self._on(attention_mask))
        uncond = self.t5(self._on(neg_input_ids),
                         self._on(neg_attention_mask))
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
                        init_latents: Optional[torch.Tensor] = None,
                        rows: Optional[tuple] = None) -> torch.Tensor:
        """Initial latents (B, F, h, w, 4) from standard-normal ``noise``
        (drawn from ``generator`` unless given): interpolated noise
        (frame 0's noise on every frame), init-latent alpha decay, residual
        noise. ``rows`` (:meth:`clip_rows`): the noise is drawn (or given)
        for the whole request and these rows kept; ``batch`` and
        ``init_latents`` are the rows'."""
        f, h, w = spec.video_length, spec.height // 8, spec.width // 8
        shape = (batch, f, h, w, 4)
        if noise is None:
            gdev = generator.device if generator is not None else self.device
            noise = torch.randn((rows[2],) + shape[1:] if rows else shape,
                                generator=generator, device=gdev,
                                dtype=torch.float32)
        if rows is not None:
            noise = noise[rows[0]:rows[1]]
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
                mask: Optional[torch.Tensor], fps: Optional[torch.Tensor],
                motion_score: Optional[torch.Tensor],
                camera_motion_type: Optional[torch.Tensor] = None,
                partial_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                step_noise: Optional[torch.Tensor] = None,
                context_t5: Optional[torch.Tensor] = None,
                rows: Optional[tuple] = None) -> torch.Tensor:
        """The denoise loop over :func:`request_plan`; ``context`` (and the
        T5 states ``context_t5``, where given) is ``[uncond; cond]`` under
        CFG, the cond rows alone without. With ``rows``
        (:meth:`clip_rows`), ``latents`` and the per-clip inputs are those
        rows of the request and ``context``, ``context_t5`` and
        ``step_noise`` the whole request's: the rows' contexts are taken
        from them, and each step's fresh noise is drawn for the whole
        request and the rows kept.

        The solver (``spec.scheduler``) scales the initial latents by its
        ``init_noise_sigma``, each UNet input by ``scale_model_input``, and
        carries its state from call to call. Under CFG with a shared prefix
        the UNet gets the un-duplicated latents with the doubled context and
        duplicates at its first cross-attention; with
        ``share_cfg_prefix=False``, and on the full steps of a PAB schedule
        (the JAX sampler's ``build_x``), it gets them duplicated. The PAB
        cache is a dict this loop owns and passes to every site. A step on
        the cond half runs the UNet on the cond rows with the cond context
        and takes the uncond prediction from the last full step, or under
        ``cfg_cache_extrapolate`` its first-order forecast
        ``u1 + (i − i1)·(u1 − u0)/(i1 − i0)`` from the last two. With
        ``video_scale > 0`` (and CFG) a per-frame pass of the same UNet
        (frames folded into the batch, F = 1, no fps, motion or ip
        conditioning; the context tiled ``[uncond; cond; …][:b·f]`` as the
        reference pairs it) gives ``frame``, and the guidance is
        ``frame + video_scale·(uncond − frame)
        + guidance·(text − uncond)``.

        The click mask and the first-frame latent (times ``partial_mask``
        where given) reach the UNet as 5 channels beside the latents only
        when the UNet has ``use_first_frame_mask_condition_concat`` (its
        9-channel ``conv_in``); otherwise it gets the bare latents, and
        ``first_image_latents``, ``mask`` and ``partial_mask`` are not read;
        a UNet with ``use_first_frame_condition_concat`` gets
        ``first_image_latents`` as ``reference_images_latent``.

        DDIM at ``eta > 0`` and Euler-A add fresh standard-normal noise each
        step: ``step_noise[i]`` (``(n_calls, B, F, h, w, 4)``) where given,
        else a draw from ``generator``."""
        b, f, h, w, _ = latents.shape
        dt = latents.dtype
        solver = make_solver(spec.scheduler, self.config.noise_scheduler,
                             spec.num_inference_steps)
        start, stop, total = rows if rows is not None else (0, b, b)
        whole_context = context

        def own(c):
            """The rows' part of a whole request's ``[uncond; cond]``."""
            if c is None or rows is None:
                return c
            if not spec.do_cfg:
                return c[start:stop]
            return torch.cat([c[start:stop], c[total + start:total + stop]])

        context, context_t5 = own(context), own(context_t5)
        if solver.init_noise_sigma != 1.0:
            latents = latents * solver.init_noise_sigma
        do_cfg = spec.do_cfg
        share = spec.share_cfg_prefix and do_cfg
        cond_channels = None
        if self.config.unet.use_first_frame_mask_condition_concat:
            if first_image_latents is None:
                raise ValueError(
                    "unet.use_first_frame_mask_condition_concat is on: the "
                    "first-frame latent is required")
            ffl = self._on(first_image_latents, dt)
            if partial_mask is not None:
                ffl = ffl * self._on(partial_mask, dt)
            first_block = torch.zeros(b, f, h, w, 4, device=self.device,
                                      dtype=dt)
            first_block[:, 0] = ffl
            if mask is not None:
                mask_block = self._on(mask, dt).clamp(0.0, 1.0)[:, None] \
                    .expand(b, f, h, w, 1)
            else:
                mask_block = torch.zeros(b, f, h, w, 1, device=self.device,
                                         dtype=dt)
                mask_block[:, 0] = 1.0
            cond_channels = torch.cat([mask_block, first_block], dim=-1)
        aux = dict(fps=self._on(fps, torch.float32),
                   motion_score=self._on(motion_score, torch.float32),
                   camera_motion_type=self._on(camera_motion_type,
                                               torch.float32))
        if self.config.unet.use_first_frame_condition_concat:
            aux["reference_images_latent"] = self._on(first_image_latents, dt)
        cond = UNetConditioning(context=context, context_t5=context_t5,
                                **aux)
        cond_half = UNetConditioning(
            context=context[b:], context_t5=(None if context_t5 is None
                                             else context_t5[b:]), **aux)
        frame_ctx = None
        if do_cfg and spec.video_scale > 0:
            ucfg = self.config.unet
            base = whole_context[:, :whole_context.shape[1]
                                 - ucfg.ip_num_tokens] \
                if ucfg.use_ip_cross_attention else whole_context
            frame_ctx = UNetConditioning(context=base.repeat(f, 1, 1)[
                start * f:stop * f])
        stochastic = spec.eta > 0 or solver.needs_step_noise
        if stochastic and step_noise is not None and tuple(
                step_noise.shape) != (solver.n_calls, total, f, h, w, 4):
            raise ValueError(f"step_noise {tuple(step_noise.shape)}, "
                             f"expected {(solver.n_calls, total, f, h, w, 4)}")

        def noise_at(i):
            if not stochastic:
                return None
            if step_noise is not None:
                return self._on(step_noise[i, start:stop], torch.float32)
            gdev = generator.device if generator is not None else self.device
            return self._on(torch.randn(
                (total, f, h, w, 4), generator=generator, device=gdev,
                dtype=torch.float32)[start:stop])

        extrap = spec.cfg_cache_extrapolate and spec.cfg_cache_interval > 1
        state = solver.init_state((b, f, h, w, 4), self.device)
        cache: dict = {}
        u1 = u0 = None
        i1 = i0 = -1
        for i, _, full, mode in request_plan(spec, solver.n_calls):
            t = solver.timestep(i).to(self.device)
            x = solver.scale_model_input(latents, i)
            if cond_channels is not None:
                x = torch.cat([x, cond_channels], dim=-1)
            frame_x = x
            if do_cfg and full and (mode is not None or not share):
                x = torch.cat([x, x], dim=0)
            out = self.unet(x, t.expand(x.shape[0]),
                            cond if full else cond_half, mode, cache)
            if not do_cfg:
                noise_pred = out
            elif full:
                uncond, text = out.chunk(2, dim=0)
                u0, i0 = (uncond, i) if i1 < 0 else (u1, i1)
                u1, i1 = uncond, i
                noise_pred = uncond + spec.guidance_scale * (text - uncond)
                if frame_ctx is not None:
                    frame = self.unet(
                        frame_x.reshape(b * f, 1, h, w, frame_x.shape[-1]),
                        t.expand(b * f), frame_ctx, plain=True).reshape(
                            b, f, h, w, 4)
                    noise_pred = (frame + spec.video_scale * (uncond - frame)
                                  + spec.guidance_scale * (text - uncond))
            else:
                text, uncond = out, u1
                if extrap:
                    slope = (i - i1) / max(i1 - i0, 1)
                    uncond = (u1.float() + (u1.float() - u0.float()) * slope
                              ).to(u1.dtype)
                noise_pred = uncond + spec.guidance_scale * (text - uncond)
            latents, state = solver.step(noise_pred, i, latents, state,
                                         eta=spec.eta, noise=noise_at(i))
        return latents

    def decode_latents(self, latents: torch.Tensor,
                       frame_chunk: int = 0) -> torch.Tensor:
        """(B, F, h, w, 4) → video (B, F, H, W, 3) fp32 in [0, 1]. All B·F
        frames decode as one batch, or, with ``frame_chunk > 0``, ``chunk·B``
        frames a batch in (F, B) order, the last batch padded with the
        leading frames (the JAX package's frame-scanned decode)."""
        b, f = latents.shape[:2]
        z = latents.to(self.dtype) / VAE_SCALE
        if frame_chunk <= 0:
            img = self.vae.decode(z.reshape(b * f, *z.shape[2:]))
            video = img.reshape(b, f, *img.shape[1:])
        else:
            chunk = max(1, min(frame_chunk, f))
            zf = z.transpose(0, 1)  # (F, B, h, w, 4)
            pad = (-f) % chunk
            if pad:
                zf = torch.cat([zf, zf[:pad]], dim=0)
            zc = zf.reshape(-1, chunk * b, *zf.shape[2:])
            frames = torch.stack([self.vae.decode(z_c) for z_c in zc])
            video = frames.reshape(-1, b, *frames.shape[2:])[:f] \
                .transpose(0, 1)
        return (video / 2.0 + 0.5).clamp(0.0, 1.0).float()

    @torch.inference_mode()
    @checked_precision()
    def sample(self, input_ids: torch.Tensor, neg_input_ids: torch.Tensor,
               first_image_latents: Optional[torch.Tensor],
               mask: Optional[torch.Tensor],
               fps: Optional[torch.Tensor],
               motion_score: Optional[torch.Tensor],
               spec: SampleSpec = SampleSpec(),
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               ip_pixel_values: Optional[torch.Tensor] = None,
               camera_motion_type: Optional[torch.Tensor] = None,
               partial_mask: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None,
               t5_input_ids: Optional[torch.Tensor] = None,
               t5_attention_mask: Optional[torch.Tensor] = None,
               t5_neg_input_ids: Optional[torch.Tensor] = None,
               t5_neg_attention_mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Token ids (B, 77) + first-frame latent (B, h, w, 4) + click mask
        (B, h, w, 1) + fps and motion score (B,) → video (B, F, H, W, 3).
        ``noise`` (B, F, h, w, 4) replaces the initial draw from
        ``generator``, ``step_noise`` (n_calls, B, F, h, w, 4) the draws of a
        stochastic solver (DDIM at ``eta > 0``, Euler-A); ``ip_pixel_values``
        (B, 224, 224, 3) is the image prompt, required when the UNet has
        ``use_ip_cross_attention``; ``camera_motion_type`` (B,) reaches the
        UNet when it has ``use_camera_motion_condition``; ``partial_mask``
        multiplies the first-frame latent channels. The first-frame latent
        and the mask may be None when the UNet has no
        ``use_first_frame_mask_condition_concat``; the first-frame latent is
        also the init image of ``use_first_image_as_init_latents``. The T5
        token ids and padding masks (B, S), cond and uncond, go through the
        pipeline's T5 encoder into the UNet's T5 cross-attention."""
        spec.check_ported()
        if ip_pixel_values is None and \
                self.config.unet.use_ip_cross_attention:
            raise ValueError(
                "unet.use_ip_cross_attention is on: the attention layers "
                "treat the last ip_num_tokens of the context as image tokens, "
                "so ip_pixel_values (CLIP pixel values) are required")
        b = int(input_ids.shape[0])
        context = self.encode_prompt(input_ids, neg_input_ids)
        if ip_pixel_values is not None:
            ip_tokens = self.encode_image_prompt(ip_pixel_values)
            context = torch.cat([context, ip_tokens.to(context.dtype)],
                                dim=1)
        context_t5 = None
        if t5_input_ids is not None:
            context_t5 = self.encode_prompt_t5(
                t5_input_ids, t5_attention_mask, t5_neg_input_ids,
                t5_neg_attention_mask)
        if not spec.do_cfg:
            context = context[b:]
            context_t5 = None if context_t5 is None else context_t5[b:]
        if not self.config.unet.use_camera_motion_condition:
            camera_motion_type = None
        rows = self.clip_rows(b)
        if rows is not None:
            def mine(x):
                """The rank's rows of a per-clip input (one row for every
                clip broadcasts)."""
                if x is None or torch.as_tensor(x).shape[0] != b:
                    return x
                return torch.as_tensor(x)[rows[0]:rows[1]]

            first_image_latents, mask, fps, motion_score, \
                camera_motion_type, partial_mask = map(mine, (
                    first_image_latents, mask, fps, motion_score,
                    camera_motion_type, partial_mask))
            b = rows[1] - rows[0]
        latents = self.prepare_latents(
            b, spec, generator=generator, noise=noise,
            init_latents=(first_image_latents
                          if spec.use_first_image_as_init_latents else None),
            rows=rows)
        latents = self.denoise(latents, context, spec, first_image_latents,
                               mask, fps, motion_score, camera_motion_type,
                               partial_mask, generator, step_noise,
                               context_t5, rows)
        video = self.decode_latents(latents)
        if rows is not None:
            video = self._gather_clips(video, rows)
        return video

    def _gather_clips(self, video: torch.Tensor, rows: tuple
                      ) -> torch.Tensor:
        """Every data rank's clips, in request order (each rank's rows
        padded to the first rank's count for the gather)."""
        from followyourclick_tpu_torch.parallel.tensor_parallel import (
            all_gather,
        )

        start, stop, total = rows
        per = -(-total // self.mesh.data_size)
        pad = video.new_zeros((per - (stop - start),) + video.shape[1:])
        parts = all_gather(torch.cat([video, pad]).contiguous(),
                           self.mesh.data_group)
        return torch.cat(parts)[:total]

    @checked_precision()
    def __call__(self, prompt: Sequence[str] | str,
                 negative_prompt: Optional[Sequence[str] | str] = None,
                 spec: SampleSpec = SampleSpec(),
                 first_image_latents=None, mask=None,
                 fps: Optional[float] = 8.0,
                 motion_score: Optional[float] = 20.0,
                 camera_motion_type: Optional[float] = None,
                 seed: int = 0, ip_image=None, partial_mask=None,
                 noise: Optional[torch.Tensor] = None,
                 step_noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """Prompts (+ first-frame latents (B, h, w, 4), click mask
        (B, h, w, 1) and, for an IP UNet, CLIP pixel values ``ip_image``
        (B, 224, 224, 3) from ``utils/video_io.clip_preprocess_image``) →
        the video (B, F, H, W, 3) float32 in [0, 1], as numpy. fps, motion
        score and camera type are one value for every clip, passed where
        the UNet reads them. The noise comes from a ``torch.Generator`` on
        the pipeline's device seeded with ``seed``, unless ``noise`` (and
        for a stochastic solver ``step_noise``) is given."""
        if isinstance(prompt, str):
            prompt = [prompt]
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        input_ids, neg_ids = self.tokenize(prompt, negative_prompt)
        b = input_ids.shape[0]
        ucfg = self.config.unet

        t5_kwargs = {}
        if self.t5 is not None and ucfg.use_text_encoder_2:
            ids2, m2, nids2, nm2 = self.tokenize_2(prompt, negative_prompt)
            t5_kwargs = dict(
                t5_input_ids=torch.from_numpy(ids2),
                t5_attention_mask=torch.from_numpy(m2),
                t5_neg_input_ids=torch.from_numpy(nids2),
                t5_neg_attention_mask=torch.from_numpy(nm2))
        if ip_image is not None and self.ip_adapter is None:
            raise ValueError("pass ip_adapter= to the pipeline to use "
                             "ip_image")
        if ip_image is None and ucfg.use_ip_cross_attention:
            raise ValueError(
                "unet.use_ip_cross_attention is on: the attention layers "
                "treat the last ip_num_tokens of the context as image tokens, "
                "so an ip_image (CLIP pixel values) is required")

        def bcast(v, used):
            return None if v is None or not used else \
                torch.full((b,), float(v), dtype=torch.float32)

        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        video = self.sample(
            torch.from_numpy(input_ids), torch.from_numpy(neg_ids),
            first_image_latents, mask,
            bcast(fps, ucfg.use_fps_condition),
            bcast(motion_score, ucfg.use_fps_condition), spec=spec,
            generator=generator, noise=noise,
            ip_pixel_values=(None if ip_image is None
                             else torch.as_tensor(np.asarray(ip_image))),
            camera_motion_type=bcast(camera_motion_type,
                                     ucfg.use_camera_motion_condition),
            partial_mask=partial_mask, step_noise=step_noise, **t5_kwargs)
        return video.cpu().numpy()
