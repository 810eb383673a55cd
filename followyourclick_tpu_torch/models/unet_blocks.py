"""UNet3D down / mid / up blocks: per layer ResnetBlock3D → SpatialTransformer3D
→ MotionModule, with down- and upsampling.

Port of ``followyourclick_tpu/models/unet_blocks.py``. ``pab`` and
``cache`` (``models/pab.py``) pass through to every attention site, the
projected T5 states ``context_2`` to every spatial transformer and the
first-frame time embedding ``temb_frame0`` to every resnet; the config's
attention options (IP-Adapter, ``upcast_attention``, T5, cross-frame and
in-block temporal attention) reach every spatial transformer, its conv
options (``use_pseudo_conv3d``, ``use_temporal_conv``) every resnet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from followyourclick_tpu_torch.config import UNet3DConfig
from followyourclick_tpu_torch.models.attention import SpatialTransformer3D
from followyourclick_tpu_torch.models.motion_module import MotionModule
from followyourclick_tpu_torch.models.resnet import (
    Downsample3D,
    ResnetBlock3D,
    Upsample3D,
    tile_to_batch,
)


def _spatial_transformer(cfg: UNet3DConfig, ch: int) -> SpatialTransformer3D:
    heads = cfg.attention_head_dim  # diffusers SD-1.5: the head COUNT
    return SpatialTransformer3D(
        ch, heads, ch // heads, 1, cfg.cross_attention_dim,
        cfg.norm_num_groups,
        ip_num_tokens=cfg.ip_num_tokens if cfg.use_ip_cross_attention else 0,
        ip_scale=cfg.ip_scale, upcast_attention=cfg.upcast_attention,
        use_text_encoder_2=cfg.use_text_encoder_2,
        cross_frame_attention=cfg.unet_use_cross_frame_attention,
        temporal_attention=cfg.unet_use_temporal_attention)


def _resnet(cfg: UNet3DConfig, in_ch: int, out_ch: int) -> ResnetBlock3D:
    return ResnetBlock3D(in_ch, out_ch, cfg.time_embed_dim,
                         groups=cfg.norm_num_groups,
                         eps=cfg.norm_eps if cfg.norm_eps else 1e-6,
                         use_inflated_groupnorm=cfg.use_inflated_groupnorm,
                         use_pseudo_conv3d=cfg.use_pseudo_conv3d,
                         use_temporal_conv=cfg.use_temporal_conv)


class _DownBlock(nn.Module):
    def __init__(self, cfg: UNet3DConfig, in_channels: int,
                 out_channels: int, num_layers: int, add_downsample: bool,
                 use_motion: bool, cross_attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            _resnet(cfg, in_channels if i == 0 else out_channels,
                    out_channels) for i in range(num_layers))
        self.attentions = (nn.ModuleList(
            _spatial_transformer(cfg, out_channels)
            for _ in range(num_layers)) if cross_attention else None)
        self.motion_modules = (nn.ModuleList(
            MotionModule(out_channels, cfg.motion_module)
            for _ in range(num_layers)) if use_motion else None)
        self.downsamplers = (nn.ModuleList([Downsample3D(
            out_channels, out_channels, cfg.downsample_padding)])
            if add_downsample else None)

    def forward(self, hidden_states, temb, context=None, pab=None,
                cache=None, context_2=None, temb_frame0=None):
        output_states = []
        for i, resnet in enumerate(self.resnets):
            hidden_states = resnet(hidden_states, temb, temb_frame0)
            if self.attentions is not None:
                hidden_states = self.attentions[i](hidden_states, context,
                                                   pab, cache, context_2)
            if self.motion_modules is not None:
                hidden_states = self.motion_modules[i](hidden_states, pab,
                                                       cache)
            output_states.append(hidden_states)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states.append(hidden_states)
        return hidden_states, output_states


class CrossAttnDownBlock3D(_DownBlock):
    def __init__(self, cfg, in_channels, out_channels, num_layers=2,
                 add_downsample=True, use_motion=True):
        super().__init__(cfg, in_channels, out_channels, num_layers,
                         add_downsample, use_motion, cross_attention=True)


class DownBlock3D(_DownBlock):
    def __init__(self, cfg, in_channels, out_channels, num_layers=2,
                 add_downsample=True, use_motion=True):
        super().__init__(cfg, in_channels, out_channels, num_layers,
                         add_downsample, use_motion, cross_attention=False)

    def forward(self, hidden_states, temb, context=None, pab=None,
                cache=None, context_2=None, temb_frame0=None):
        return super().forward(hidden_states, temb, None, pab, cache, None,
                               temb_frame0)


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, cfg: UNet3DConfig, in_channels: int,
                 num_layers: int = 1, use_motion: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            _resnet(cfg, in_channels, in_channels)
            for _ in range(num_layers + 1))
        self.attentions = nn.ModuleList(
            _spatial_transformer(cfg, in_channels) for _ in range(num_layers))
        self.motion_modules = (nn.ModuleList(
            MotionModule(in_channels, cfg.motion_module)
            for _ in range(num_layers)) if use_motion else None)

    def forward(self, hidden_states, temb, context, pab=None, cache=None,
                context_2=None, temb_frame0=None):
        hidden_states = self.resnets[0](hidden_states, temb, temb_frame0)
        for i, attn in enumerate(self.attentions):
            hidden_states = attn(hidden_states, context, pab, cache,
                                 context_2)
            if self.motion_modules is not None:
                hidden_states = self.motion_modules[i](hidden_states, pab,
                                                       cache)
            hidden_states = self.resnets[i + 1](hidden_states, temb,
                                                temb_frame0)
        return hidden_states


class _UpBlock(nn.Module):
    def __init__(self, cfg: UNet3DConfig, skip_channels: Sequence[int],
                 prev_output_channel: int, out_channels: int,
                 add_upsample: bool, use_motion: bool,
                 cross_attention: bool):
        super().__init__()
        n = len(skip_channels)
        self.resnets = nn.ModuleList(
            _resnet(cfg, (prev_output_channel if i == 0 else out_channels)
                    + skip_channels[i], out_channels) for i in range(n))
        self.attentions = (nn.ModuleList(
            _spatial_transformer(cfg, out_channels) for _ in range(n))
            if cross_attention else None)
        self.motion_modules = (nn.ModuleList(
            MotionModule(out_channels, cfg.motion_module) for _ in range(n))
            if use_motion else None)
        self.upsamplers = (nn.ModuleList([Upsample3D(out_channels,
                                                     out_channels)])
                           if add_upsample else None)

    def forward(self, hidden_states, res_hidden_states, temb, context=None,
                pab=None, cache=None, context_2=None, temb_frame0=None):
        res_list = list(res_hidden_states)
        for i, resnet in enumerate(self.resnets):
            # skips saved before the CFG duplication point (conv_in output)
            # are at the pre-CFG batch
            res = tile_to_batch(res_list.pop(), hidden_states.shape[0])
            hidden_states = torch.cat([hidden_states, res], dim=-1)
            hidden_states = resnet(hidden_states, temb, temb_frame0)
            if self.attentions is not None:
                hidden_states = self.attentions[i](hidden_states, context,
                                                   pab, cache, context_2)
            if self.motion_modules is not None:
                hidden_states = self.motion_modules[i](hidden_states, pab,
                                                       cache)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class CrossAttnUpBlock3D(_UpBlock):
    """``skip_channels``: channels of the skips this block consumes, in the
    order it pops them (deepest first)."""

    def __init__(self, cfg, skip_channels, prev_output_channel, out_channels,
                 add_upsample=True, use_motion=True):
        super().__init__(cfg, skip_channels, prev_output_channel,
                         out_channels, add_upsample, use_motion,
                         cross_attention=True)


class UpBlock3D(_UpBlock):
    def __init__(self, cfg, skip_channels, prev_output_channel, out_channels,
                 add_upsample=True, use_motion=True):
        super().__init__(cfg, skip_channels, prev_output_channel,
                         out_channels, add_upsample, use_motion,
                         cross_attention=False)

    def forward(self, hidden_states, res_hidden_states, temb, context=None,
                pab=None, cache=None, context_2=None, temb_frame0=None):
        return super().forward(hidden_states, res_hidden_states, temb, None,
                               pab, cache, None, temb_frame0)
