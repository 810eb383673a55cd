"""LiteFlowNet (NetC + NetE).

Port of ``followyourclick_tpu/flow/liteflownet.py`` (mmflow
``liteflownet_encoder.py`` and ``liteflownet_decoder.py``), NCHW: the NetC
pyramid (32, 32, 64, 96, 128, 192; strides 1, 2, 2, 2, 2, 2; first kernel
7), then per level 6 → 2 a cascade of

- :class:`MatchingBlock`: correlation d = 3 (at levels 2-3 on every
  second position at step 2, the 49-channel volume upsampled 2x), convs
  (128, 64, 32), a flow residual;
- :class:`SubpixelBlock`: (feat1, warped feat2, flow) → convs → residual;
- :class:`RegularizationBlock`: feature-driven distance kernels
  (softmax(−d²), patch 7 / 5 / 5 / 3 / 3, a separable (p, 1)(1, p) head
  where p > 3) over zero-padded neighbourhoods of the flow;

with the fixed bilinear 2x upsampler between levels and the flow scaled
at warp time by ``flow_div · 2^(1 − level)``.

Submodules carry the JAX module names (``NetM_level6.pred_flow``,
``NetR_level3.dist1``, ``feat_layer_level2``, ``encoder.level2_conv1``).
:func:`liteflownet_stage_load` copies one level's trained blocks onto
another in a port state dict, as the JAX function does on a flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.flow.ops import (
    bilinear_resize,
    flow_warp,
    local_correlation,
)
from followyourclick_tpu_torch.flow.pwcnet import (
    conv,
    leaky,
    native_convolutions,
    upsampled,
)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """The fixed bilinear 2x upsampler (no value scaling)."""
    return bilinear_resize(x, 2 * x.shape[2], 2 * x.shape[3])


def _unfold(x: torch.Tensor, patch: int) -> torch.Tensor:
    """``(B, 1, H, W)`` → ``(B, patch², H, W)`` zero-padded
    neighbourhoods (``F.unfold`` with padding ``patch // 2``)."""
    B, _, H, W = x.shape
    return F.unfold(x, patch, padding=patch // 2).reshape(B, -1, H, W)


class Convs(nn.Module):
    """``conv0..`` 3x3 convs with LeakyReLU, then ``pred_flow`` (patch x
    patch) to a flow residual."""

    def __init__(self, cin: int, feat_channels: Tuple[int, ...],
                 patch_size: int):
        super().__init__()
        for i, ch in enumerate(feat_channels):
            self.add_module(f"conv{i}", conv(cin, ch))
            cin = ch
        self.num = len(feat_channels)
        self.pred_flow = conv(cin, 2, patch_size)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = leaky(getattr(self, f"conv{i}")(x))
        return self.pred_flow(x)


class NetC(nn.Module):
    """The pyramid encoder, ``{level: feature}``."""

    def __init__(self, out_channels=(32, 32, 64, 96, 128, 192),
                 strides=(1, 2, 2, 2, 2, 2), num_convs=(1, 3, 2, 2, 1, 1),
                 kernel_sizes=(7, 3, 3, 3, 3, 3)):
        super().__init__()
        self.num_convs = tuple(num_convs)
        cin = 3
        for i, (ch, stride, n, k) in enumerate(zip(
                out_channels, strides, num_convs, kernel_sizes)):
            for j in range(n):
                self.add_module(f"level{i + 1}_conv{j}",
                                conv(cin, ch, k, stride if j == 0 else 1))
                cin = ch

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        feats = {}
        for i, n in enumerate(self.num_convs):
            for j in range(n):
                x = leaky(getattr(self, f"level{i + 1}_conv{j}")(x))
            feats[i + 1] = x
        return feats


class MatchingBlock(Convs):
    """Correlation → convs → flow residual (mmflow
    ``liteflownet_decoder.py:117-188``)."""

    def __init__(self, corr_stride: int = 1, corr_dilation: int = 1,
                 patch_size: int = 3,
                 feat_channels: Tuple[int, ...] = (128, 64, 32)):
        super().__init__(49, feat_channels, patch_size)
        self.corr_stride = corr_stride
        self.corr_dilation = corr_dilation

    def forward(self, feat1, feat2, upflow, multiplier: float):
        if upflow is None:
            warp_feat = feat2
            upflow = feat1.new_zeros(feat1.shape[0], 2, *feat1.shape[2:])
        else:
            warp_feat = flow_warp(feat2, upflow * multiplier)
        corr = leaky(local_correlation(
            feat1, warp_feat, max_displacement=3,
            dilation_patch=self.corr_dilation, stride=self.corr_stride))
        if self.corr_stride > 1:
            corr = _up2(corr)
        return upflow + self.residual(corr)


class SubpixelBlock(Convs):
    """Subpixel refinement (mmflow ``liteflownet_decoder.py:190-231``)."""

    def __init__(self, feat_channels_in: int, patch_size: int = 3,
                 feat_channels: Tuple[int, ...] = (128, 64, 32)):
        super().__init__(2 * feat_channels_in + 2, feat_channels, patch_size)

    def forward(self, feat1, feat2, flow, multiplier: float):
        warp_feat = flow_warp(feat2, flow * multiplier)
        return flow + self.residual(torch.cat([feat1, warp_feat, flow],
                                              dim=1))


class RegularizationBlock(nn.Module):
    """Feature-driven local-convolution regularisation (mmflow
    ``liteflownet_decoder.py:233-314``)."""

    def __init__(self, feat_in: int, patch_size: int = 3,
                 feat_channels: Tuple[int, ...] = (128, 128, 64, 64, 32,
                                                   32)):
        super().__init__()
        cin = 3 + feat_in
        for i, ch in enumerate(feat_channels):
            self.add_module(f"conv{i}", conv(cin, ch))
            cin = ch
        self.num = len(feat_channels)
        p = self.patch_size = patch_size
        if p > 3:
            # the separable distance head: (p, 1) then (1, p)
            self.dist0 = nn.Conv2d(cin, p * p, (p, 1), padding=(p // 2, 0))
            self.dist1 = nn.Conv2d(p * p, p * p, (1, p), padding=(0, p // 2))
        else:
            self.dist0 = conv(cin, p * p, p)

    def forward(self, img1, img2, feat, flow, multiplier: float):
        warp_img2 = flow_warp(img2, flow * multiplier)
        diff = torch.sqrt(((img1 - warp_img2) ** 2).sum(dim=1, keepdim=True))
        nomean = flow - flow.mean(dim=(2, 3), keepdim=True)
        x = torch.cat([diff, nomean, feat], dim=1)
        for i in range(self.num):
            x = leaky(getattr(self, f"conv{i}")(x))
        p = self.patch_size
        d = self.dist1(self.dist0(x)) if p > 3 else self.dist0(x)
        k = torch.softmax(-(d.float() ** 2), dim=1)
        fx = (k * _unfold(flow[:, :1], p)).sum(dim=1)
        fy = (k * _unfold(flow[:, 1:], p)).sum(dim=1)
        return torch.stack([fx, fy], dim=1).to(flow.dtype)


@dataclasses.dataclass(frozen=True)
class LiteFlowNetConfig:
    flow_div: float = 20.0
    feat_channels: int = 64
    regularized_flow: bool = True


PATCH = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}
CORR_STRIDE = {2: 2, 3: 2, 4: 1, 5: 1, 6: 1}
LEVELS = (6, 5, 4, 3, 2)
RFEAT_CHANNELS = 128


class LiteFlowNet(nn.Module):
    """NetC + NetE, levels 6 → 2: ``{"level6": …, "level2": …}`` flows over
    ``flow_div``, or with ``inference`` the level-2 flow resized to the
    image in pixels."""

    def __init__(self, config: LiteFlowNetConfig = LiteFlowNetConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = NetC()
        raw = dict(zip(range(1, 7), (32, 32, 64, 96, 128, 192)))
        for level in LEVELS:
            ch = raw[level]
            if ch < cfg.feat_channels:
                self.add_module(f"feat_layer_level{level}",
                                conv(ch, cfg.feat_channels, 1))
            fch = max(ch, cfg.feat_channels)
            self.add_module(f"NetM_level{level}", MatchingBlock(
                CORR_STRIDE[level], CORR_STRIDE[level], PATCH[level]))
            self.add_module(f"NetS_level{level}",
                            SubpixelBlock(fch, PATCH[level]))
            if level == 2 and not cfg.regularized_flow:
                continue
            if ch < RFEAT_CHANNELS:
                self.add_module(f"rfeat_layer_level{level}",
                                conv(ch, RFEAT_CHANNELS, 1))
            self.add_module(f"NetR_level{level}", RegularizationBlock(
                max(ch, RFEAT_CHANNELS), PATCH[level]))

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        cfg = self.config
        feat1 = self.encoder(img1)
        feat2 = self.encoder(img2)
        preds = {}
        upflow = None
        for level in LEVELS:
            raw1, raw2 = feat1[level], feat2[level]
            h, w = raw1.shape[2:]
            multiplier = cfg.flow_div * 2.0 ** (1 - level)
            if raw1.shape[1] < cfg.feat_channels:
                proj = getattr(self, f"feat_layer_level{level}")
                f1, f2 = leaky(proj(raw1)), leaky(proj(raw2))
            else:
                f1, f2 = raw1, raw2
            flow = getattr(self, f"NetM_level{level}")(f1, f2, upflow,
                                                       multiplier)
            flow = getattr(self, f"NetS_level{level}")(f1, f2, flow,
                                                       multiplier)
            if not (level == 2 and not cfg.regularized_flow):
                rfeat = raw1
                if raw1.shape[1] < RFEAT_CHANNELS:
                    rfeat = leaky(getattr(
                        self, f"rfeat_layer_level{level}")(raw1))
                flow = getattr(self, f"NetR_level{level}")(
                    bilinear_resize(img1, h, w), bilinear_resize(img2, h, w),
                    rfeat, flow, multiplier)
            preds[level] = flow
            upflow = _up2(flow)
        if inference:
            return upsampled(preds[2], *img1.shape[2:], cfg.flow_div)
        return {f"level{k}": v for k, v in preds.items()}


def liteflownet_stage_load(state: Mapping[str, torch.Tensor],
                           src_level: int,
                           dst_level: int) -> Dict[str, torch.Tensor]:
    """Progressive stage training (mmflow
    ``core/hooks/liteflownet_stage_loading.py``): a copy of the port state
    dict ``state`` in which every tensor under a top-level module named
    ``*_level<src>`` is copied onto the same name under ``*_level<dst>``
    where that exists with the same shape (the rest keep their values, as
    a non-strict ``load_state_dict``)."""
    out = dict(state)
    src, dst = f"level{src_level}", f"level{dst_level}"
    for name, value in state.items():
        top, _, rest = name.partition(".")
        if not top.endswith(src):
            continue
        target = f"{top[:-len(src)]}{dst}.{rest}"
        if target in out and out[target].shape == value.shape:
            out[target] = value
    return out
