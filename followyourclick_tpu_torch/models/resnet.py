"""Pseudo-3D convolutional blocks on ``(B, F, H, W, C)`` clips.

Port of ``followyourclick_tpu/models/resnet.py``: per-frame 2-D convs
(``InflatedConv``), ``ResnetBlock3D``, ``Downsample3D``, ``Upsample3D``.
Activations stay channels-last; a conv sees the frames folded into the batch
as an ``NCHW`` view with channels-last strides, which is what cuDNN prefers.
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
    """norm1 → SiLU → conv1 → (+temb) → norm2 → SiLU → conv2 → +shortcut.

    The norms run on the 5-D clip (statistics over F, H, W and the group)
    unless ``use_inflated_groupnorm``, which takes them per frame. The SiLU
    is folded into the norm.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int = 32,
                 eps: float = 1e-6, use_inflated_groupnorm: bool = False,
                 output_scale_factor: float = 1.0):
        super().__init__()
        self.use_inflated_groupnorm = use_inflated_groupnorm
        self.output_scale_factor = output_scale_factor
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = InflatedConv(in_channels, out_channels, 3)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = InflatedConv(out_channels, out_channels, 3)
        self.conv_shortcut = (InflatedConv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _norm(self, norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
        if self.use_inflated_groupnorm:
            folded, f = fold_frames(x)
            return unfold_frames(norm(folded), f)
        return norm(x)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor]) -> torch.Tensor:
        hidden = self.conv1(self._norm(self.norm1, x))
        if temb is not None:
            temb = tile_to_batch(temb, x.shape[0])
            t = self.time_emb_proj(torch.nn.functional.silu(temb))
            hidden = hidden + t[:, None, None, None, :]
        hidden = self.conv2(self._norm(self.norm2, hidden))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return (x + hidden) / self.output_scale_factor
