"""PWC-Net optical-flow estimator.

Port of ``followyourclick_tpu/flow/pwcnet.py`` (mmflow's ``PWCNetEncoder``,
``PWCNetDecoder`` and ``ContextNet``), NCHW: a 6-level pyramid of strided
3x3 convs, a coarse-to-fine decoder (level 6 → 2) that warps the second
image's features by the upsampled flow, correlates them with the first's
(``flow/ops.local_correlation``, window 2d+1 = 9) and runs a dense block,
and a dilated context network added to the finest flow.

Submodules carry the JAX module names (``encoder.level1_conv0``,
``decoder_level6.dense0``, ``post_processor.conv0``, …), so
``flow/convert.flow_state_from_jax`` reads a JAX tree by name. The
transposed convs are flax's ``ConvTranspose(4, 2, "VALID",
transpose_kernel=True)`` cropped by one pixel a side, which is
``nn.ConvTranspose2d(4, 2, padding=1)`` with the kernel read as a conv's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.flow.ops import (
    bilinear_resize,
    flow_warp,
    local_correlation,
)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def native_convolutions(forward):
    """An estimator's ``forward`` with cuDNN off inside, the previous
    setting restored after: on the card its convolutions take PyTorch's
    own CUDA route (im2col and a cuBLAS product). cuDNN's fp32 engines at
    these shapes (FFT tiling, implicit GEMM) round a 3x3 conv 5-7x further
    from fp64 than the CPU does, and the flows 2-5x (the CPU fp32's own
    distance is the card's gate); PyTorch's route keeps them at
    0.95-1.5x (``chip_profile.py estimators``). On the CPU nothing
    changes."""

    @functools.wraps(forward)
    def run(*args, **kwargs):
        saved = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            return forward(*args, **kwargs)
        finally:
            torch.backends.cudnn.enabled = saved

    return run


def conv(cin: int, cout: int, k: int = 3, stride: int = 1,
         padding: Optional[int] = None, dilation: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (k, k), strides, padding=k // 2)``."""
    return nn.Conv2d(cin, cout, k, stride,
                     k // 2 if padding is None else padding, dilation,
                     bias=bias)


def up_conv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """The k4 / s2 transposed conv that doubles H and W."""
    return nn.ConvTranspose2d(cin, cout, 4, 2, 1)


def upsampled(flow: torch.Tensor, H: int, W: int,
              scale: float = 1.0) -> torch.Tensor:
    """``jax.image.resize(flow, (B, H, W, C), "bilinear") * scale``."""
    return bilinear_resize(flow, H, W) * scale


def corr_channels(max_displacement: int) -> int:
    return (2 * max_displacement + 1) ** 2


@dataclasses.dataclass(frozen=True)
class PWCNetConfig:
    pyramid_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 196)
    # convs per pyramid level: 3 for 'Basic' (PWC-Net), 2 for 'Small'
    # (IRR-PWC)
    encoder_num_convs: int = 3
    densefeat_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    max_displacement: int = 4
    flow_div: float = 20.0
    flow_levels: Tuple[int, ...] = (2, 3, 4, 5, 6)
    context_channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32)
    context_dilations: Tuple[int, ...] = (1, 2, 4, 8, 16, 1)


class PWCNetEncoder(nn.Module):
    """6-level pyramid; ``forward`` gives ``{level: (B, C_l, H/2^l,
    W/2^l)}``."""

    def __init__(self, config: PWCNetConfig = PWCNetConfig(),
                 in_channels: int = 3):
        super().__init__()
        self.config = config
        cin = in_channels
        for lvl, ch in enumerate(config.pyramid_channels, start=1):
            for j in range(config.encoder_num_convs):
                self.add_module(f"level{lvl}_conv{j}",
                                conv(cin, ch, stride=2 if j == 0 else 1))
                cin = ch

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        cfg = self.config
        feats = {}
        for lvl in range(1, len(cfg.pyramid_channels) + 1):
            for j in range(cfg.encoder_num_convs):
                x = leaky(getattr(self, f"level{lvl}_conv{j}")(x))
            feats[lvl] = x
        return feats


class DenseBlock(nn.Module):
    """Dense connectivity: each conv's output is put in front of its
    input (``concat(leaky(conv(x)), x)``)."""

    def __init__(self, cin: int, channels: Tuple[int, ...]):
        super().__init__()
        for i, ch in enumerate(channels):
            self.add_module(f"dense{i}", conv(cin, ch))
            cin += ch
        self.out_channels = cin
        self.num = len(channels)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = torch.cat([leaky(getattr(self, f"dense{i}")(x)), x], dim=1)
        return x


class PWCModule(DenseBlock):
    """Dense block + flow head + up layers (mmflow
    ``pwcnet_decoder.py:16-88``): returns (flow, feat, upflow, upfeat)."""

    def __init__(self, cin: int, up_flow: bool = True,
                 densefeat_channels: Tuple[int, ...] = (128, 128, 96, 64,
                                                        32)):
        super().__init__(cin, densefeat_channels)
        self.predict = conv(self.out_channels, 2)
        self.up_flow = up_flow
        if up_flow:
            self.upflow = up_conv(2, 2)
            self.upfeat = up_conv(self.out_channels, 2)

    def forward(self, x: torch.Tensor):
        feat = self.dense(x)
        flow = self.predict(feat)
        if not self.up_flow:
            return flow, feat, None, None
        return flow, feat, self.upflow(flow), self.upfeat(feat)


class ContextNet(nn.Module):
    """Dilated refinement (mmflow ``context_net.py``); 2 output channels
    for a flow, 1 for IRR-PWC's occlusion post-processor."""

    def __init__(self, cin: int,
                 feat_channels: Tuple[int, ...] = (128, 128, 128, 96, 64,
                                                   32),
                 dilations: Tuple[int, ...] = (1, 2, 4, 8, 16, 1),
                 out_channels: int = 2):
        super().__init__()
        for i, (ch, dil) in enumerate(zip(feat_channels, dilations)):
            self.add_module(f"conv{i}", conv(cin, ch, padding=dil,
                                             dilation=dil))
            cin = ch
        self.num = len(feat_channels)
        self.predict = conv(cin, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = leaky(getattr(self, f"conv{i}")(x))
        return self.predict(x)


class PWCNet(nn.Module):
    """``forward(img1, img2)`` (normalised ``(B, 3, H, W)``) → ``{"level6":
    …, "level2": …}`` flows over ``flow_div``, or with ``inference`` the
    finest flow resized to ``(B, 2, H, W)`` in pixels."""

    def __init__(self, config: PWCNetConfig = PWCNetConfig()):
        super().__init__()
        self.config = config
        self.encoder = PWCNetEncoder(config)
        levels = sorted(config.flow_levels, reverse=True)
        nc = corr_channels(config.max_displacement)
        feat = None
        for level in levels:
            cin = nc if level == levels[0] else (
                nc + config.pyramid_channels[level - 1] + 4)
            block = PWCModule(cin, level != levels[-1],
                              config.densefeat_channels)
            self.add_module(f"decoder_level{level}", block)
            feat = block.out_channels
        self.post_processor = ContextNet(feat, config.context_channels,
                                         config.context_dilations)

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        cfg = self.config
        feat1 = self.encoder(img1)
        feat2 = self.encoder(img2)
        levels = sorted(cfg.flow_levels, reverse=True)
        preds = {}
        upflow = upfeat = last_feat = None
        for level in levels:
            f1, f2 = feat1[level], feat2[level]
            if level == levels[0]:
                x = leaky(local_correlation(f1, f2, cfg.max_displacement))
            else:
                warped = flow_warp(f2, upflow * (cfg.flow_div
                                                 * 2.0 ** (-level)))
                corr = leaky(local_correlation(f1, warped,
                                               cfg.max_displacement))
                x = torch.cat([corr, f1, upflow, upfeat], dim=1)
            flow, last_feat, upflow, upfeat = getattr(
                self, f"decoder_level{level}")(x)
            preds[level] = flow
        preds[levels[-1]] = preds[levels[-1]] + self.post_processor(
            last_feat)
        if inference:
            return upsampled(preds[levels[-1]], *img1.shape[2:],
                             cfg.flow_div)
        return {f"level{k}": v for k, v in preds.items()}
