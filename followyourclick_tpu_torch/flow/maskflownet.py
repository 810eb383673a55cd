"""MaskFlowNetS and the two-stage MaskFlowNet.

Port of ``followyourclick_tpu/flow/maskflownet.py`` (mmflow
``maskflownet_decoder.py`` and ``flow_estimators/maskflownet.py``), NCHW:
the PWC pyramid, a per-level asymmetric occlusion-aware feature matching
(the second image's features warped by the upsampled flow, a 3x3 conv,
gated by a learned occlusion mask and added to a conv of the upsampled
feature), correlation, dense decoders that predict a flow residual and a
mask, and the dilated context network. MaskFlowNet adds a second stage on
(image 1, 0) and (warped image 2, mask) with two d = 2 correlations a
level.

As in the JAX package:

- mmcv's ``DeformConv2d`` is called with one offset for all nine taps (the
  flow), which by the linearity of bilinear sampling is a 3x3 conv of the
  warped feature: :class:`DeformWarpBlock` is ``flow_warp``, a bias-free
  conv and a separate ``deconv_bias``, with no deformable conv;
- the flow stays in (x, y) order inside, where mmflow keeps mmcv's (y, x)
  and flips at the output: the same model up to a permutation of the flow
  heads' weights.

Submodules carry the JAX module names (``warp_level5.tradeoff_conv``,
``decoder_level4.predict_mask``, ``maskflownetS.encoder.…``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from followyourclick_tpu_torch.flow.ops import flow_warp, local_correlation
from followyourclick_tpu_torch.flow.pwcnet import (
    ContextNet,
    DenseBlock,
    PWCNetConfig,
    PWCNetEncoder,
    conv,
    corr_channels,
    leaky,
    native_convolutions,
    up_conv,
    upsampled,
)


def upsample2_align_corners(img: torch.Tensor) -> torch.Tensor:
    """MaskFlowNet's 2x upsampler (mmflow ``maskflownet_decoder.py:17-36``:
    replicate pad right and bottom, bilinear with aligned corners to 2H+1,
    drop the last row and column): the originals interleaved with the
    averages of their right / lower neighbours."""
    B, C, H, W = img.shape
    x = torch.cat([img, img[:, :, -1:]], dim=2)
    rows = torch.stack([x[:, :, :-1], 0.5 * (x[:, :, :-1] + x[:, :, 1:])],
                       dim=3).reshape(B, C, 2 * H, W)
    y = torch.cat([rows, rows[..., -1:]], dim=3)
    return torch.stack([y[..., :-1], 0.5 * (y[..., :-1] + y[..., 1:])],
                       dim=4).reshape(B, C, 2 * H, 2 * W)


class DeformWarpBlock(nn.Module):
    """The AsymOFMM warp: ``leaky(conv(warp(feat2, flow)) + deconv_bias)``,
    with the trade-off ``leaky(deform · sigmoid(mask) +
    tradeoff_conv(up_feat))``."""

    def __init__(self, channels: int, with_tradeoff: bool = True,
                 up_channels: int = 16):
        super().__init__()
        self.deconv = conv(channels, channels, bias=False)
        self.deconv_bias = nn.Parameter(torch.zeros(channels))
        self.with_tradeoff = with_tradeoff
        if with_tradeoff:
            self.tradeoff_conv = conv(up_channels, channels)

    def forward(self, feat2, flow, mask_feat=None, up_feat=None):
        deform = self.deconv(flow_warp(feat2, flow)) \
            + self.deconv_bias[:, None, None]
        if not self.with_tradeoff:
            return leaky(deform)
        return leaky(deform * torch.sigmoid(mask_feat)
                     + self.tradeoff_conv(up_feat))


class MaskModule(DenseBlock):
    """Dense block, a flow residual head, the occlusion mask head and the
    up layers (mmflow ``maskflownet_decoder.py:236-303``): ``(flow, mask,
    feat, upflow, upmask, upfeat)``."""

    def __init__(self, cin: int, up_flow: bool, with_mask: bool,
                 up_channels: int = 16,
                 densefeat_channels: Tuple[int, ...] = (128, 128, 96, 64,
                                                        32)):
        super().__init__(cin, densefeat_channels)
        self.up_flow = up_flow
        self.with_mask = with_mask
        self.predict_flow = conv(self.out_channels, 2)
        if with_mask:
            self.predict_mask = conv(self.out_channels, 1)
        if up_flow:
            self.upfeat = up_conv(self.out_channels, up_channels)

    def forward(self, x: torch.Tensor, upflow: torch.Tensor):
        feat = self.dense(x)
        flow = self.predict_flow(feat) + upflow
        mask = new_upflow = upmask = upfeat = None
        if self.with_mask:
            mask = self.predict_mask(feat)
            if self.up_flow:
                upmask = upsample2_align_corners(mask)
        if self.up_flow:
            new_upflow = upsample2_align_corners(flow)
            upfeat = leaky(self.upfeat(feat))
        return flow, mask, feat, new_upflow, upmask, upfeat


@dataclasses.dataclass(frozen=True)
class MaskFlowNetSConfig:
    pyramid_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 196)
    densefeat_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    max_displacement: int = 4
    flow_div: float = 20.0
    up_channels: int = 16
    context_channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32)
    context_dilations: Tuple[int, ...] = (1, 2, 4, 8, 16, 1)


LEVELS = (6, 5, 4, 3, 2)


def encoder(cfg: MaskFlowNetSConfig, in_channels: int = 3) -> PWCNetEncoder:
    return PWCNetEncoder(PWCNetConfig(pyramid_channels=cfg.pyramid_channels),
                         in_channels)


def mask_at_image(last_mask: torch.Tensor) -> torch.Tensor:
    """The level-3 upsampled mask taken twice more to the image's size."""
    return upsample2_align_corners(upsample2_align_corners(last_mask))


class MaskFlowNetS(nn.Module):
    """Stage 1 (mmflow ``maskflownet_decoder.py:410-467``): flows over
    ``flow_div`` for levels 6 → 2; ``return_mask`` adds the learned
    occlusion mask ``(B, 1, H, W)`` (logits), ``return_features`` gives
    ``(flows by level number, mask, feat1, feat2)`` for stage 2."""

    def __init__(self, config: MaskFlowNetSConfig = MaskFlowNetSConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = encoder(cfg)
        nc = corr_channels(cfg.max_displacement)
        feat = None
        for level in LEVELS:
            ch = cfg.pyramid_channels[level - 1]
            if level != LEVELS[0]:
                self.add_module(f"warp_level{level}", DeformWarpBlock(
                    ch, up_channels=cfg.up_channels))
            cin = nc if level == LEVELS[0] else (
                nc + ch + cfg.up_channels + 2)
            block = MaskModule(cin, level != LEVELS[-1], level != LEVELS[-1],
                               cfg.up_channels, cfg.densefeat_channels)
            self.add_module(f"decoder_level{level}", block)
            feat = block.out_channels
        self.post_processor = ContextNet(feat, cfg.context_channels,
                                         cfg.context_dilations)

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False, return_mask: bool = False,
                return_features: bool = False):
        cfg = self.config
        feat1 = self.encoder(img1)
        feat2 = self.encoder(img2)
        preds = {}
        upflow = upmask = upfeat = last_feat = last_mask = None
        for level in LEVELS:
            f1, f2 = feat1[level], feat2[level]
            if level == LEVELS[0]:
                x = leaky(local_correlation(f1, f2, cfg.max_displacement))
                upflow0 = f1.new_zeros(f1.shape[0], 2, *f1.shape[2:])
            else:
                warped = getattr(self, f"warp_level{level}")(
                    f2, upflow * (cfg.flow_div * 2.0 ** (-level)), upmask,
                    upfeat)
                corr = leaky(local_correlation(f1, warped,
                                               cfg.max_displacement))
                x = torch.cat([corr, f1, upfeat, upflow], dim=1)
                upflow0 = upflow
            flow, _, last_feat, upflow, upmask, upfeat = getattr(
                self, f"decoder_level{level}")(x, upflow0)
            if level == 3:
                # the level-3 upsampled mask seeds stage 2
                last_mask = upmask
            preds[level] = flow
        preds[LEVELS[-1]] = preds[LEVELS[-1]] + self.post_processor(
            last_feat)
        if return_features:
            return preds, mask_at_image(last_mask), feat1, feat2
        out = {f"level{k}": v for k, v in preds.items()}
        if inference:
            out = upsampled(preds[2], *img1.shape[2:], cfg.flow_div)
        if return_mask:
            return out, mask_at_image(last_mask)
        return out


class MaskFlowNet(nn.Module):
    """Both stages (mmflow ``flow_estimators/maskflownet.py:57-153``):
    stage 2 encodes ``(img1, 0)`` and ``(img2 warped by the upsampled
    stage-1 flow, mask)`` with its own pyramid and refines each level from
    two d = 2 correlations (stage-1 features warped by the running flow
    through a trade-off-free :class:`DeformWarpBlock`; the stage-2 pair),
    maskless decoders and a context network."""

    D2 = 2

    def __init__(self, config: MaskFlowNetSConfig = MaskFlowNetSConfig()):
        super().__init__()
        cfg = self.config = config
        self.maskflownetS = MaskFlowNetS(cfg)
        self.encoder = encoder(cfg, in_channels=4)
        nc = 2 * corr_channels(self.D2)
        feat = None
        for level in LEVELS:
            ch = cfg.pyramid_channels[level - 1]
            self.add_module(f"warp_level{level}",
                            DeformWarpBlock(ch, with_tradeoff=False))
            cin = nc + 2 if level == LEVELS[0] else (
                ch + cfg.up_channels + nc + 4)
            block = MaskModule(cin, level != LEVELS[-1], False,
                               cfg.up_channels, cfg.densefeat_channels)
            self.add_module(f"decoder_level{level}", block)
            feat = block.out_channels
        self.post_processor = ContextNet(feat, cfg.context_channels,
                                         cfg.context_dilations)

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        cfg = self.config
        flows1, mask1, feat1, feat2 = self.maskflownetS(
            img1, img2, return_features=True)
        H, W = img1.shape[2:]
        warped2 = flow_warp(img2, upsampled(flows1[2], H, W, cfg.flow_div))
        feat3 = self.encoder(torch.cat([img1, torch.zeros_like(mask1)],
                                       dim=1))
        feat4 = self.encoder(torch.cat([warped2, mask1], dim=1))
        preds = {}
        upflow = upfeat = last_feat = None
        for level in LEVELS:
            i_flow = flows1[level]
            if level == LEVELS[0]:
                upflow = i_flow
            warped1 = getattr(self, f"warp_level{level}")(
                feat2[level], upflow * (cfg.flow_div * 2.0 ** (-level)))
            corr = torch.cat([
                leaky(local_correlation(feat1[level], warped1, self.D2)),
                leaky(local_correlation(feat3[level], feat4[level],
                                        self.D2))], dim=1)
            if upfeat is None:
                x = torch.cat([corr, upflow], dim=1)
            else:
                x = torch.cat([feat1[level], upfeat, corr, upflow, i_flow],
                              dim=1)
            flow, _, last_feat, upflow, _, upfeat = getattr(
                self, f"decoder_level{level}")(x, upflow)
            preds[level] = flow
        preds[LEVELS[-1]] = preds[LEVELS[-1]] + self.post_processor(
            last_feat)
        if inference:
            return upsampled(preds[2], H, W, cfg.flow_div)
        return {f"level{k}": v for k, v in preds.items()}
