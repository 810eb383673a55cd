"""UNet3DConditionModel: the SD-1.5 UNet inflated to video with motion modules.

Port of ``followyourclick_tpu/models/unet3d.py``: time, camera-motion,
fps and motion-score embeddings, the 9-channel ``conv_in`` (noisy latent,
click mask, first-frame latent), the down / mid / up topology,
``conv_norm_out`` with SiLU over the whole clip, ``conv_out``, and the PAB
sites of the serving schedules (``models/pab.py``), the DeepCache trunk site
among them, the IP-Adapter's decoupled cross-attention
(``use_ip_cross_attention``: the context ends in ``ip_num_tokens`` image
tokens), and every other option of ``UNet3DConfig`` the JAX UNet runs:
``center_input_sample``, class embeddings (``num_class_embeds``), the
first-frame latent concatenated over the frames
(``use_first_frame_condition_concat``, halved after ``conv_in``), the
``PseudoConv3d`` convs and temporal conv blocks, the zero-initialised T5
projection (``use_text_encoder_2``), the first-frame zero-timestep
embedding, ``motion_module_decoder_only`` and the attention options of
``models/attention.py``. Two options the JAX UNet declares but never reads
raise: ``resnet_time_scale_shift`` other than "default" and a
``class_embed_type``.

``remat_blocks`` (JAX ``UNet3DConditionModel.remat_blocks``): under
autograd each down, mid and up block is its own
``torch.utils.checkpoint`` region, so the backward keeps the blocks'
boundaries and one block's internals; a forward without grad is unchanged.

Tensors are ``(B, F, H, W, C)``. CFG prefix sharing (exact): when
``cond.context`` has twice the sample's batch, the stem runs once and the
hidden states duplicate at the first cross-attention.
"""

from __future__ import annotations

import contextlib
import operator
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from followyourclick_tpu_torch.config import UNet3DConfig
from followyourclick_tpu_torch.models.attention import CrossAttention
from followyourclick_tpu_torch.models.layers import (
    GroupNorm,
    TimestepEmbedding,
    sinusoidal_timestep_embedding,
)
from followyourclick_tpu_torch.models.pab import PabMode, name_sites, pab_site
from followyourclick_tpu_torch.models.resnet import (
    InflatedConv,
    PseudoConv3d,
    tile_to_batch,
)
from followyourclick_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlock3D,
    CrossAttnUpBlock3D,
    DownBlock3D,
    UNetMidBlock3DCrossAttn,
    UpBlock3D,
)


@dataclass
class UNetConditioning:
    """Conditioning of one denoise step. ``context`` and ``context_t5``
    carry the CFG layout ([uncond; cond] when doubled); ``fps``,
    ``motion_score`` and ``camera_motion_type`` (an index of
    ``data/camera_motion.MOTION_TYPES``) may be at the sample's batch or
    the context's; ``class_labels`` and ``reference_images_latent`` are at
    the sample's batch and tiled where the batch doubles.
    ``first_frame_zero_timestep``: frame 0 of every resnet takes the t = 0
    time embedding."""

    context: torch.Tensor                       # (B, 77 [+ ip tokens], 768)
    fps: Optional[torch.Tensor] = None          # (B,)
    motion_score: Optional[torch.Tensor] = None  # (B,)
    camera_motion_type: Optional[torch.Tensor] = None  # (B,)
    class_labels: Optional[torch.Tensor] = None  # (B,) int
    context_t5: Optional[torch.Tensor] = None   # (B, S2, 4096) raw T5 states
    reference_images_latent: Optional[torch.Tensor] = None  # (B, h, w, 4)
    first_frame_zero_timestep: bool = False


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNet3DConfig, remat_blocks: bool = False):
        super().__init__()
        cfg = self.config = config
        self.remat_blocks = remat_blocks
        # declared by the JAX config, never read by the JAX UNet
        if cfg.class_embed_type is not None:
            raise NotImplementedError(
                f"class_embed_type={cfg.class_embed_type!r}")
        if cfg.resnet_time_scale_shift != "default":
            raise NotImplementedError(cfg.resnet_time_scale_shift)
        boc = list(cfg.block_out_channels)
        c0, temb = boc[0], cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(c0, temb)
        if cfg.use_camera_motion_condition:
            self.camera_motion_embedding = TimestepEmbedding(
                c0, temb, zero_init_output=True)
        if cfg.use_fps_condition:
            self.fps_embedding = TimestepEmbedding(c0, temb,
                                                   zero_init_output=True)
            self.motion_embedding = TimestepEmbedding(c0, temb,
                                                      zero_init_output=True)
        if cfg.num_class_embeds is not None:
            self.class_embedding = nn.Embedding(cfg.num_class_embeds, temb)
        conv_in = PseudoConv3d if cfg.use_pseudo_conv3d else InflatedConv
        self.conv_in = conv_in(self.conv_in_channels(cfg), c0, 3)
        if cfg.use_text_encoder_2:
            self.text_encoder_proj_model_t5 = nn.Linear(
                cfg.text_encoder_2_dim, cfg.cross_attention_dim)
            nn.init.zeros_(self.text_encoder_proj_model_t5.weight)
            nn.init.zeros_(self.text_encoder_proj_model_t5.bias)

        def use_motion(level: int) -> bool:
            return (cfg.use_motion_module
                    and 2 ** level in tuple(cfg.motion_module_resolutions))

        skips = [c0]
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.down_block_types):
            final = i == len(boc) - 1
            args = (cfg, boc[max(i - 1, 0)], boc[i], cfg.layers_per_block,
                    not final,
                    use_motion(i) and not cfg.motion_module_decoder_only)
            if kind == "CrossAttnDownBlock3D":
                self.down_blocks.append(CrossAttnDownBlock3D(*args))
            elif kind == "DownBlock3D":
                self.down_blocks.append(DownBlock3D(*args))
            else:
                raise ValueError(kind)
            skips += [boc[i]] * (cfg.layers_per_block + (0 if final else 1))

        if cfg.mid_block_type != "UNetMidBlock3DCrossAttn":
            raise ValueError(cfg.mid_block_type)
        self.mid_block = UNetMidBlock3DCrossAttn(
            cfg, boc[-1], use_motion=(cfg.use_motion_module
                                      and cfg.motion_module_mid_block))

        rev = list(reversed(boc))
        n_skip = cfg.layers_per_block + 1
        self.n_skip = n_skip
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.up_block_types):
            mine, skips = skips[-n_skip:], skips[:-n_skip]
            args = (cfg, list(reversed(mine)), rev[max(i - 1, 0)], rev[i],
                    i != len(boc) - 1, use_motion(len(boc) - 1 - i))
            if kind == "CrossAttnUpBlock3D":
                self.up_blocks.append(CrossAttnUpBlock3D(*args))
            elif kind == "UpBlock3D":
                self.up_blocks.append(UpBlock3D(*args))
            else:
                raise ValueError(kind)

        self.conv_norm_out = GroupNorm(c0, cfg.norm_num_groups, cfg.norm_eps,
                                       act="silu")
        self.conv_out = InflatedConv(c0, cfg.out_channels, 3)
        name_sites(self)
        # each block's parameter names (remat_blocks), listed while they
        # are registered: inside a functional_call they are not
        for b in (*self.down_blocks, self.mid_block, *self.up_blocks):
            b.param_names = [n for n, _ in b.named_parameters()]

    @staticmethod
    def conv_in_channels(cfg: UNet3DConfig) -> int:
        """``conv_in``'s input channels: the sample the caller passes (the
        latents, and with ``use_first_frame_mask_condition_concat`` the
        click mask and first-frame latent), plus the first-frame latent the
        UNet concatenates under ``use_first_frame_condition_concat``. The
        JAX UNet infers it from its input, so with both flags it is not
        ``cfg.conv_in_channels``."""
        c = cfg.in_channels
        if cfg.use_first_frame_mask_condition_concat:
            c += cfg.in_channels + 1
        if cfg.use_first_frame_condition_concat:
            c += cfg.in_channels
        return c

    def _block(self, block: nn.Module, *args):
        """``block(*args)``, a checkpoint region under ``remat_blocks``. The
        region holds the parameter tensors the block has now (those a
        ``functional_call`` put in place too), so that the backward's
        recompute, which runs after such a call has put the module's own
        back, reads the same ones."""
        if not (self.remat_blocks and torch.is_grad_enabled()):
            return block(*args)
        params = {n: operator.attrgetter(n)(block)
                  for n in block.param_names}
        return checkpoint(lambda *a: functional_call(block, params, a),
                          *args, use_reentrant=False)

    @contextlib.contextmanager
    def _ip_off(self):
        """Within the block every cross-attention treats the whole context
        as text, as a UNet built without ``use_ip_cross_attention``."""
        mods = [m for m in self.modules()
                if isinstance(m, CrossAttention) and m.ip_num_tokens]
        for m in mods:
            m.ip_num_tokens = 0
        try:
            yield
        finally:
            for m in mods:
                m.ip_num_tokens = self.config.ip_num_tokens

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                cond: UNetConditioning, pab: Optional[PabMode] = None,
                cache: Optional[dict] = None,
                plain: bool = False) -> torch.Tensor:
        """``pab``: the step's reuse / record flags (None: exact); ``cache``:
        the sampler's PAB cache, updated in place. ``plain``: the
        ``video_scale`` per-frame pass, which runs these parameters as a
        UNet whose config has ``use_fps_condition`` and
        ``use_ip_cross_attention`` off (the JAX pipeline's ``unet_plain``):
        no fps or motion-score embedding, no ip tokens in the context."""
        if plain and self.config.use_ip_cross_attention:
            with self._ip_off():
                return self._forward(sample, timesteps, cond, pab, cache,
                                     True)
        return self._forward(sample, timesteps, cond, pab, cache, plain)

    def _forward(self, sample, timesteps, cond, pab, cache, plain):
        cfg = self.config
        b, f = sample.shape[:2]
        dtype = self.conv_out.conv.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)
        if cfg.center_input_sample:
            sample = 2.0 * sample - 1.0

        def sin_emb(x):
            return sinusoidal_timestep_embedding(
                x, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                cfg.freq_shift).to(dtype)

        def aux(a):
            a = torch.as_tensor(a, device=sample.device)
            return tile_to_batch(a, b) if a.ndim else a.expand(b)

        emb = self.time_embedding(sin_emb(timesteps))
        emb_frame0 = None
        if cond.first_frame_zero_timestep:
            emb_frame0 = self.time_embedding(sin_emb(torch.zeros_like(
                timesteps)))
        if cfg.use_camera_motion_condition \
                and cond.camera_motion_type is not None:
            emb = emb + self.camera_motion_embedding(
                sin_emb(aux(cond.camera_motion_type)))
        if cfg.use_fps_condition and not plain:
            if cond.fps is None or cond.motion_score is None:
                raise ValueError("use_fps_condition requires cond.fps and "
                                 "cond.motion_score")
            emb = emb + self.fps_embedding(sin_emb(aux(cond.fps)))
            emb = emb + self.motion_embedding(
                sin_emb(aux(cond.motion_score)))
        if cfg.num_class_embeds is not None:
            if cond.class_labels is None:
                raise ValueError("num_class_embeds requires cond.class_labels")
            emb = emb + self.class_embedding(torch.as_tensor(
                cond.class_labels, device=sample.device))

        sample = sample.to(dtype)
        if cfg.use_first_frame_condition_concat:
            if cond.reference_images_latent is None:
                raise ValueError("use_first_frame_condition_concat requires "
                                 "cond.reference_images_latent")
            ref = tile_to_batch(cond.reference_images_latent, b).to(dtype)
            sample = torch.cat([sample, ref[:, None].expand(
                b, f, *ref.shape[1:])], dim=-1)
        sample = self.conv_in(sample)
        if cfg.use_first_frame_condition_concat:
            sample = sample / 2.0

        context = cond.context.to(dtype)
        context_2 = None
        if cfg.use_text_encoder_2 and cond.context_t5 is not None:
            context_2 = self.text_encoder_proj_model_t5(
                cond.context_t5.to(dtype))
        extra = (context_2, emb_frame0)
        # level 0 (the outermost) always runs
        res_samples = [sample]
        sample, res = self._block(self.down_blocks[0], sample, emb, context,
                                  pab, cache, *extra)
        res_samples += res

        def trunk(s):
            """Down levels 1.., mid and every up block but the last: the
            DeepCache-cacheable interior."""
            skips = list(res_samples)
            for block in self.down_blocks[1:]:
                s, res = self._block(block, s, emb, context, pab, cache,
                                     *extra)
                skips += res
            s = self._block(self.mid_block, s, emb, context, pab, cache,
                            *extra)
            for block in self.up_blocks[:-1]:
                res = skips[-self.n_skip:]
                skips = skips[:-self.n_skip]
                s = self._block(block, s, res, emb, context, pab, cache,
                                *extra)
            return s

        deep_site = (pab is not None and (pab.reuse_deep or pab.record_deep)
                     and len(self.down_blocks) >= 2)
        if deep_site:
            sample = pab_site(self, "deep", "deep_trunk", pab, cache,
                              lambda: trunk(sample))
        else:
            sample = trunk(sample)
        # the last up block takes the level-0 skips, computed in either mode
        sample = self._block(self.up_blocks[-1], sample,
                             res_samples[:self.n_skip], emb, context, pab,
                             cache, *extra)
        if cfg.use_inflated_groupnorm:
            bo = sample.shape[0]
            sample = self.conv_norm_out(
                sample.reshape(bo * f, *sample.shape[2:])).reshape(
                    sample.shape)
        else:
            # plain GroupNorm on the 5-D clip: statistics over (F, H, W, C/g)
            sample = self.conv_norm_out(sample)
        return self.conv_out(sample)
