"""Pseudo-3D convolutional blocks on ``(B, F, H, W, C)`` clips.

Port of ``followyourclick_tpu/models/resnet.py``: per-frame 2-D convs
(``InflatedConv``), ``PseudoConv3d`` (a 2-D conv, then a dirac-initialised
k=3 conv along the frames), ``TemporalConvBlock``, ``ResnetBlock3D`` (with
the first-frame zero-timestep embedding ``temb_frame0``), ``Downsample3D``,
``Upsample3D``. Activations stay channels-last; a conv sees the frames
folded into the batch as an ``NCHW`` view with channels-last strides, which
is what cuDNN prefers. A conv along the frames is an ``nn.Conv1d`` whose
weight runs as a ``(3, 1, 1)`` ``conv3d`` over the channels-first clip.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from followyourclick_tpu_torch.models.layers import GroupNorm
from followyourclick_tpu_torch.ops.upsample import conv3x3_nearest_up2


def fold_frames(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(B, F, H, W, C) -> ((B·F, H, W, C), F)."""
    b, f, h, w, c = x.shape
    return x.reshape(b * f, h, w, c), f


def unfold_frames(x: torch.Tensor, frames: int) -> torch.Tensor:
    bf, h, w, c = x.shape
    return x.reshape(bf // frames, frames, h, w, c)


def tile_to_batch(t: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    """CFG prefix sharing: tile conditioning computed at the pre-duplication
    batch to batch ``b`` as whole copies ``[t; t; ...]`` (the row order of the
    in-network duplication), not ``repeat_interleave``."""
    if t is None or t.shape[0] == b:
        return t
    assert b % t.shape[0] == 0, (t.shape, b)
    return torch.cat([t] * (b // t.shape[0]), dim=0)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to a channels-last ``(N, H, W, C)`` tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class InflatedConv(nn.Module):
    """2-D conv applied independently per frame (InflatedConv3d)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded, f = fold_frames(x)
        return unfold_frames(conv_nhwc(self.conv, folded), f)


def temporal_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (kernel k, padding k // 2) along the frames of a ``(B, F, H,
    W, C)`` clip, at every position."""
    w = conv.weight[:, :, :, None, None]
    y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w, conv.bias,
                                   padding=(conv.padding[0], 0, 0))
    return y.permute(0, 2, 3, 4, 1)


class PseudoConv3d(nn.Module):
    """2-D spatial conv per frame, then a k=3 conv along the frames,
    initialised to the identity (dirac) and skipped at one frame."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.spatial_conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                                      padding=kernel_size // 2)
        self.temporal_conv = nn.Conv1d(out_channels, out_channels, 3,
                                       padding=1)
        with torch.no_grad():
            self.temporal_conv.weight.zero_()
            self.temporal_conv.weight[:, :, 1] = torch.eye(out_channels)
            self.temporal_conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded, f = fold_frames(x)
        out = unfold_frames(conv_nhwc(self.spatial_conv, folded), f)
        if f == 1:
            return out
        return temporal_conv(self.temporal_conv, out)


class TemporalConvBlock(nn.Module):
    """4 × (GroupNorm over the whole clip, 32 groups → SiLU → k=3 conv along
    the frames), the last conv zero-initialised, plus the input."""

    def __init__(self, channels: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"norm{i}", GroupNorm(channels, 32, act="silu"))
            setattr(self, f"conv{i}", nn.Conv1d(channels, channels, 3,
                                                padding=1))
        nn.init.zeros_(self.conv4.weight)
        nn.init.zeros_(self.conv4.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(1, 5):
            h = temporal_conv(getattr(self, f"conv{i}"),
                              getattr(self, f"norm{i}")(h))
        return x + h


class Downsample3D(nn.Module):
    """Stride-2 3×3 conv per frame."""

    def __init__(self, channels: int, out_channels: int, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2,
                              padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded, f = fold_frames(x)
        return unfold_frames(conv_nhwc(self.conv, folded), f)


class Upsample3D(nn.Module):
    """Nearest ×2 spatial upsample + 3×3 conv per frame; the exact
    phase-decomposed form when the output is exactly twice the input."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor,
                output_size: Optional[tuple[int, int]] = None
                ) -> torch.Tensor:
        folded, f = fold_frames(x)
        _, h, w, _ = folded.shape
        nh, nw = output_size if output_size is not None else (2 * h, 2 * w)
        weight = self.conv.weight.to(x.dtype)
        bias = self.conv.bias.to(x.dtype)
        if (nh, nw) == (2 * h, 2 * w):
            up = conv3x3_nearest_up2(folded, weight, bias)
        else:
            up = folded.repeat_interleave(nh // h, dim=1) \
                .repeat_interleave(nw // w, dim=2)
            up = conv_nhwc(self.conv, up)
        return unfold_frames(up, f)


class ResnetBlock3D(nn.Module):
    """norm1 → SiLU → conv1 → (+temb) → norm2 → SiLU → conv2 → +shortcut
    [→ ``TemporalConvBlock``].

    The norms run on the 5-D clip (statistics over F, H, W and the group)
    unless ``use_inflated_groupnorm``, which takes them per frame. The SiLU
    is folded into the norm. ``use_pseudo_conv3d`` makes conv1, conv2 and
    the shortcut ``PseudoConv3d``. With ``temb_frame0`` frame 0 takes that
    embedding's projection and the other frames ``temb``'s.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int = 32,
                 eps: float = 1e-6, use_inflated_groupnorm: bool = False,
                 output_scale_factor: float = 1.0,
                 use_pseudo_conv3d: bool = False,
                 use_temporal_conv: bool = False):
        super().__init__()
        conv = PseudoConv3d if use_pseudo_conv3d else InflatedConv
        self.use_inflated_groupnorm = use_inflated_groupnorm
        self.output_scale_factor = output_scale_factor
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = conv(in_channels, out_channels, 3)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = conv(out_channels, out_channels, 3)
        self.conv_shortcut = (conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)
        self.temporal_conv = (TemporalConvBlock(out_channels)
                              if use_temporal_conv else None)

    def _norm(self, norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
        if self.use_inflated_groupnorm:
            folded, f = fold_frames(x)
            return unfold_frames(norm(folded), f)
        return norm(x)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                temb_frame0: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.conv1(self._norm(self.norm1, x))
        if temb is not None:
            silu = torch.nn.functional.silu
            temb = tile_to_batch(temb, x.shape[0])
            t = self.time_emb_proj(silu(temb))[:, None, None, None, :]
            if temb_frame0 is not None:
                t0 = self.time_emb_proj(silu(tile_to_batch(
                    temb_frame0, x.shape[0])))[:, None, None, None, :]
                frame = torch.arange(hidden.shape[1], device=x.device)
                t = torch.where((frame == 0)[None, :, None, None, None],
                                t0, t)
            hidden = hidden + t
        hidden = self.conv2(self._norm(self.norm2, hidden))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        out = (x + hidden) / self.output_scale_factor
        if self.temporal_conv is not None:
            out = self.temporal_conv(out)
        return out
