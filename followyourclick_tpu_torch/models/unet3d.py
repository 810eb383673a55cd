"""UNet3DConditionModel: the SD-1.5 UNet inflated to video with motion modules.

Port of ``followyourclick_tpu/models/unet3d.py`` on the exact path: time,
fps and motion-score embeddings, the 9-channel ``conv_in`` (noisy latent,
click mask, first-frame latent), the down / mid / up topology,
``conv_norm_out`` with SiLU over the whole clip, and ``conv_out``. Camera
motion, T5, IP-Adapter, class embeddings, PseudoConv3d, temporal convs and
the DeepCache trunk site are not ported yet and raise.

Tensors are ``(B, F, H, W, C)``. CFG prefix sharing (exact): when
``cond.context`` has twice the sample's batch, the stem runs once and the
hidden states duplicate at the first cross-attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from followyourclick_tpu_torch.config import UNet3DConfig
from followyourclick_tpu_torch.models.layers import (
    GroupNorm,
    TimestepEmbedding,
    sinusoidal_timestep_embedding,
)
from followyourclick_tpu_torch.models.resnet import InflatedConv, tile_to_batch
from followyourclick_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlock3D,
    CrossAttnUpBlock3D,
    DownBlock3D,
    UNetMidBlock3DCrossAttn,
    UpBlock3D,
)

_NOT_PORTED = ("center_input_sample", "use_camera_motion_condition",
               "use_text_encoder_2", "use_ip_cross_attention",
               "use_pseudo_conv3d", "use_temporal_conv",
               "use_first_frame_condition_concat",
               "unet_use_cross_frame_attention",
               "unet_use_temporal_attention", "motion_module_decoder_only",
               "use_linear_projection", "upcast_attention")


@dataclass
class UNetConditioning:
    """Conditioning of one denoise step. ``context`` carries the CFG layout
    ([uncond; cond] when doubled); ``fps`` and ``motion_score`` may be at the
    sample's batch or the context's."""

    context: torch.Tensor                       # (B, 77, 768)
    fps: Optional[torch.Tensor] = None          # (B,)
    motion_score: Optional[torch.Tensor] = None  # (B,)


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNet3DConfig):
        super().__init__()
        cfg = self.config = config
        for name in _NOT_PORTED:
            if getattr(cfg, name):
                raise NotImplementedError(f"UNet3DConfig.{name} is not "
                                          "ported yet")
        if cfg.num_class_embeds is not None or cfg.class_embed_type:
            raise NotImplementedError("class embeddings are not ported yet")
        if cfg.resnet_time_scale_shift != "default":
            raise NotImplementedError(cfg.resnet_time_scale_shift)
        boc = list(cfg.block_out_channels)
        c0, temb = boc[0], cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(c0, temb)
        if cfg.use_fps_condition:
            self.fps_embedding = TimestepEmbedding(c0, temb,
                                                   zero_init_output=True)
            self.motion_embedding = TimestepEmbedding(c0, temb,
                                                      zero_init_output=True)
        self.conv_in = InflatedConv(cfg.conv_in_channels, c0, 3)

        def use_motion(level: int) -> bool:
            return (cfg.use_motion_module
                    and 2 ** level in tuple(cfg.motion_module_resolutions))

        skips = [c0]
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.down_block_types):
            final = i == len(boc) - 1
            args = (cfg, boc[max(i - 1, 0)], boc[i], cfg.layers_per_block,
                    not final, use_motion(i))
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

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                cond: UNetConditioning) -> torch.Tensor:
        cfg = self.config
        b, f = sample.shape[:2]
        dtype = self.conv_in.conv.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)

        def sin_emb(x):
            return sinusoidal_timestep_embedding(
                x, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                cfg.freq_shift).to(dtype)

        def aux(a):
            a = torch.as_tensor(a, device=sample.device)
            return tile_to_batch(a, b) if a.ndim else a.expand(b)

        emb = self.time_embedding(sin_emb(timesteps))
        if cfg.use_fps_condition:
            if cond.fps is None or cond.motion_score is None:
                raise ValueError("use_fps_condition requires cond.fps and "
                                 "cond.motion_score")
            emb = emb + self.fps_embedding(sin_emb(aux(cond.fps)))
            emb = emb + self.motion_embedding(
                sin_emb(aux(cond.motion_score)))

        context = cond.context.to(dtype)
        sample = self.conv_in(sample.to(dtype))
        res_samples = [sample]
        for block in self.down_blocks:
            sample, res = block(sample, emb, context)
            res_samples += res
        sample = self.mid_block(sample, emb, context)
        for block in self.up_blocks:
            res = res_samples[-self.n_skip:]
            res_samples = res_samples[:-self.n_skip]
            sample = block(sample, res, emb, context)
        if cfg.use_inflated_groupnorm:
            bo = sample.shape[0]
            sample = self.conv_norm_out(
                sample.reshape(bo * f, *sample.shape[2:])).reshape(
                    sample.shape)
        else:
            # plain GroupNorm on the 5-D clip: statistics over (F, H, W, C/g)
            sample = self.conv_norm_out(sample)
        return self.conv_out(sample)
