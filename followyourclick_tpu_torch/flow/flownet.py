"""FlowNetS, FlowNetC and the stacked FlowNetCSS.

Port of ``followyourclick_tpu/flow/flownet.py`` (mmflow's
``FlowNetEncoder``, ``CorrEncoder``, ``FlowNetSDecoder`` /
``FlowNetCDecoder`` and the ``BasicLink`` of FlowNet2), NCHW:

- FlowNetS reads the 6-channel image pair through a 6-level encoder
  (64, 128, 256, 512, 512, 1024; kernels 7, 5, (5, 3), 3, 3, 3);
- FlowNetC runs a shared 3-level stem on each image, correlates the
  level-3 features over a 21x21 window at step 2 (d = 10, 441 channels),
  adds a 1x1 redirect of image 1's features and encodes levels 3-6;
- both decode coarse to fine (level 6 → 2): a 3x3 flow head, then k4 / s2
  transposed convs that upsample the features (LeakyReLU) and the flow;
- FlowNetCSS warps image 2 by FlowNetC's flow and refines with one or two
  FlowNetS stages on the 12-channel stack.

Submodules carry the JAX module names (``encoder.level3.conv1``,
``corr_level4.conv0``, ``decoder.level5.deconv``, ``flownetS1.…``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from followyourclick_tpu_torch.flow.ops import flow_warp, local_correlation
from followyourclick_tpu_torch.flow.pwcnet import (
    conv,
    leaky,
    native_convolutions,
    up_conv,
    upsampled,
)


class ConvStack(nn.Module):
    """One pyramid level (mmflow ``BasicConvBlock``): the first conv
    strided, each followed by LeakyReLU; ``channels`` gives each conv's
    width."""

    def __init__(self, cin: int, channels: Sequence[int],
                 kernel_sizes: Sequence[int], stride: int = 2):
        super().__init__()
        for j, (ch, k) in enumerate(zip(channels, kernel_sizes)):
            self.add_module(f"conv{j}",
                            conv(cin, ch, k, stride if j == 0 else 1))
            cin = ch
        self.num = len(channels)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.num):
            x = leaky(getattr(self, f"conv{j}")(x))
        return x


Width = Union[int, Tuple[int, ...]]


class FlowNetEncoder(nn.Module):
    """Pyramid encoder, ``{level: feature}``. An ``out_channels`` entry may
    be a tuple (one width per conv); ``strides`` defaults to 2 a level."""

    def __init__(self, cin: int, out_channels: Sequence[Width],
                 kernel_sizes: Sequence[Width], num_convs: Sequence[int],
                 strides: Optional[Sequence[int]] = None):
        super().__init__()
        for i, ch in enumerate(out_channels):
            ks = kernel_sizes[i]
            if isinstance(ks, int):
                ks = (ks,) * num_convs[i]
            chans = tuple(ch) if isinstance(ch, (tuple, list)) else (
                (ch,) * len(ks))
            stack = ConvStack(cin, chans, ks,
                              strides[i] if strides else 2)
            self.add_module(f"level{i + 1}", stack)
            cin = stack.out_channels
        self.num = len(out_channels)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        feats = {}
        for i in range(1, self.num + 1):
            x = getattr(self, f"level{i}")(x)
            feats[i] = x
        return feats


class FlowDecoderBlock(nn.Module):
    """A decoder level (mmflow ``flownet_decoder.BasicBlock``): a 3x3 flow
    head, and unless ``out_channels`` is None the upsampled features
    (``deconv`` + LeakyReLU) and flow (``upsample_pred``); an
    ``inter_channels`` conv (the SD and fusion decoders) runs before the
    head, the feature upsampling still reads the block's input."""

    def __init__(self, cin: int, out_channels: Optional[int],
                 inter_channels: Optional[int] = None):
        super().__init__()
        head = cin
        if inter_channels is not None:
            self.inter = conv(cin, inter_channels)
            head = inter_channels
        self.predict = conv(head, 2)
        self.has_inter = inter_channels is not None
        self.has_up = out_channels is not None
        if self.has_up:
            self.deconv = up_conv(cin, out_channels)
            self.upsample_pred = up_conv(2, 2)

    def forward(self, x: torch.Tensor):
        feat = leaky(self.inter(x)) if self.has_inter else x
        flow = self.predict(feat)
        if not self.has_up:
            return flow, None, None
        return flow, self.upsample_pred(flow), leaky(self.deconv(x))


class GenericFlowNetDecoder(nn.Module):
    """Coarse-to-fine decoder over ``levels`` (descending): the coarsest
    level reads its feature, each finer one ``concat(feature, upfeat,
    upflow)``; ``{"level<l>": flow}``. ``feat_channels`` gives each level's
    feature width."""

    def __init__(self, levels: Sequence[int],
                 feat_channels: Dict[int, int],
                 out_channels: Dict[int, Optional[int]],
                 inter_channels: Optional[Dict[int, Optional[int]]] = None):
        super().__init__()
        self.levels = tuple(levels)
        inter_channels = inter_channels or {}
        up = None
        for level in self.levels:
            cin = feat_channels[level] + (0 if up is None else up + 2)
            self.add_module(f"level{level}", FlowDecoderBlock(
                cin, out_channels.get(level), inter_channels.get(level)))
            up = out_channels.get(level)

    def forward(self, feats: Dict[int, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        preds = {}
        upflow = upfeat = None
        for level in self.levels:
            x = feats[level] if upflow is None else torch.cat(
                [feats[level], upfeat, upflow], dim=1)
            flow, upflow, upfeat = getattr(self, f"level{level}")(x)
            preds[f"level{level}"] = flow
        return preds


# the FlowNetS / C decoders: feature upsampling widths per level
DECODER_OUT = {6: 512, 5: 256, 4: 128, 3: 64, 2: None}
DECODER_IN = {6: 1024, 5: 512, 4: 512, 3: 256, 2: 128}
CORR_CHANNELS = 21 * 21  # FlowNetC's window: d = 10 at step 2


def flownet_decoder() -> GenericFlowNetDecoder:
    return GenericFlowNetDecoder((6, 5, 4, 3, 2), DECODER_IN, DECODER_OUT)


@dataclasses.dataclass(frozen=True)
class FlowNetConfig:
    flow_div: float = 20.0


def inference_flow(preds: Dict[str, torch.Tensor], img: torch.Tensor,
                   flow_div: float) -> torch.Tensor:
    """The level-2 flow resized to the image, in pixels."""
    return upsampled(preds["level2"], *img.shape[2:], flow_div)


class FlowNetS(nn.Module):
    """mmflow ``flownets.py``: the stacked pair (and ``extra`` channels,
    6 of them in FlowNetCSS's refinement stages) through one encoder."""

    def __init__(self, config: FlowNetConfig = FlowNetConfig(),
                 extra_channels: int = 0):
        super().__init__()
        self.config = config
        self.encoder = FlowNetEncoder(
            6 + extra_channels, (64, 128, 256, 512, 512, 1024),
            (7, 5, (5, 3), 3, 3, 3), (1, 1, 2, 2, 2, 2))
        self.decoder = flownet_decoder()

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False,
                extra: Optional[torch.Tensor] = None):
        parts = [img1, img2] if extra is None else [img1, img2, extra]
        preds = self.decoder(self.encoder(torch.cat(parts, dim=1)))
        if inference:
            return inference_flow(preds, img1, self.config.flow_div)
        return preds


class FlowNetC(nn.Module):
    """mmflow ``flownetc.py``: the shared stem, the level-3 correlation
    (d = 10 at step 2) with a 32-channel redirect, ``corr_level3..6`` and
    a decoder that reads image 1's stem at level 2."""

    def __init__(self, config: FlowNetConfig = FlowNetConfig()):
        super().__init__()
        self.config = config
        self.encoder = FlowNetEncoder(3, (64, 128, 256), (7, 5, 5),
                                      (1, 1, 1))
        self.conv_redir = conv(256, 32, 1)
        cin = CORR_CHANNELS + 32
        for level, ch, stride, n in ((3, 256, 1, 1), (4, 512, 2, 2),
                                     (5, 512, 2, 2), (6, 1024, 2, 2)):
            self.add_module(f"corr_level{level}",
                            ConvStack(cin, (ch,) * n, (3,) * n, stride))
            cin = ch
        self.decoder = flownet_decoder()

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        feat1 = self.encoder(img1)
        feat2 = self.encoder(img2)
        corr = leaky(local_correlation(feat1[3], feat2[3],
                                       max_displacement=10,
                                       dilation_patch=2))
        x = torch.cat([corr, leaky(self.conv_redir(feat1[3]))], dim=1)
        feats = {2: feat1[2]}
        for level in (3, 4, 5, 6):
            x = getattr(self, f"corr_level{level}")(x)
            feats[level] = x
        preds = self.decoder(feats)
        if inference:
            return inference_flow(preds, img1, self.config.flow_div)
        return preds


def basic_link(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor,
               flow_div: float, scale_factor: int = 4):
    """mmflow ``BasicLink``: the coarse flow upsampled, image 2 warped by
    it times ``flow_div`` (border padding), the brightness error:
    ``(upsampled flow, warped image, error)``."""
    h, w = flow.shape[2:]
    up = upsampled(flow, h * scale_factor, w * scale_factor)
    warped = flow_warp(img2, up * flow_div, padding_mode="border")
    err = torch.sqrt(((img1 - warped) ** 2).sum(dim=1, keepdim=True))
    return up, warped, err


class FlowNetCSS(nn.Module):
    """FlowNet2-CSS (mmflow ``flow_estimators/flownet2.py:13-210``):
    FlowNetC, then one (``two_s_stages=False``) or two FlowNetS stages on
    (img1, img2, warped img2, upsampled flow, brightness error)."""

    def __init__(self, config: FlowNetConfig = FlowNetConfig(),
                 two_s_stages: bool = True):
        super().__init__()
        self.config = config
        self.two_s_stages = two_s_stages
        self.flownetC = FlowNetC(config)
        self.flownetS1 = FlowNetS(config, extra_channels=6)
        if two_s_stages:
            self.flownetS2 = FlowNetS(config, extra_channels=6)

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        div = self.config.flow_div
        flow = self.flownetC(img1, img2)["level2"]
        stages = [self.flownetS1] + ([self.flownetS2]
                                     if self.two_s_stages else [])
        for stage in stages:
            up, warped, err = basic_link(img1, img2, flow, div)
            preds = stage(img1, img2,
                          extra=torch.cat([warped, up, err], dim=1))
            flow = preds["level2"]
        if inference:
            return inference_flow(preds, img1, div)
        return preds
