"""FlowNet2: the CSS cascade, the small-displacement branch and their
fusion.

Port of ``followyourclick_tpu/flow/flownet2.py`` (mmflow
``flow_estimators/flownet2.py:212-330``), NCHW:

- FlowNetCSS (``flow/flownet.py``);
- FlowNetSD: a stride-1 64-channel stem, then six kernel-3 levels of two
  convs each ((64, 128), 128, 256, 512, 512, 1024), decoded with an extra
  3x3 conv before each flow head;
- the fusion: image 1, both branches' flows times ``flow_div`` upsampled
  to the image, their norms and brightness errors (11 channels) through a
  3-level encoder (strides 1, 2, 2) and decoder, which predicts the flow at
  full resolution with ``flow_div`` 1.

Submodules carry the JAX module names (``flownetCSS.flownetC.…``,
``flownetSD.encoder.stem``, ``fusion_decoder.level2.inter``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from followyourclick_tpu_torch.flow.flownet import (
    DECODER_IN,
    DECODER_OUT,
    ConvStack,
    FlowNetConfig,
    FlowNetCSS,
    FlowNetEncoder,
    GenericFlowNetDecoder,
)
from followyourclick_tpu_torch.flow.ops import flow_warp
from followyourclick_tpu_torch.flow.pwcnet import (
    conv,
    leaky,
    native_convolutions,
    upsampled,
)


class FlowNetSDEncoder(nn.Module):
    """mmflow ``FlowNetSDEncoder``: the stride-1 ``stem`` conv, then
    ``level1..6``, the first conv of each strided."""

    LEVELS = ((64, 128), (128, 128), (256, 256), (512, 512), (512, 512),
              (1024, 1024))

    def __init__(self, cin: int = 6, plugin_channels: int = 64):
        super().__init__()
        self.stem = conv(cin, plugin_channels)
        cin = plugin_channels
        for i, chans in enumerate(self.LEVELS):
            self.add_module(f"level{i + 1}", ConvStack(cin, chans, (3, 3)))
            cin = chans[-1]

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        x = leaky(self.stem(x))
        feats = {}
        for i in range(1, len(self.LEVELS) + 1):
            x = getattr(self, f"level{i}")(x)
            feats[i] = x
        return feats


class FlowNetSD(nn.Module):
    """The small-displacement branch: ``{"level6": …, "level2": …}``."""

    def __init__(self):
        super().__init__()
        self.encoder = FlowNetSDEncoder()
        self.decoder = GenericFlowNetDecoder(
            (6, 5, 4, 3, 2), DECODER_IN, DECODER_OUT,
            inter_channels={5: 512, 4: 256, 3: 128, 2: 64})

    @native_convolutions
    def forward(self, img1: torch.Tensor,
                img2: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.decoder(self.encoder(torch.cat([img1, img2], dim=1)))


def fusion_link(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor,
                flow_div: float, scale_factor: int = 4):
    """mmflow ``BasicLink`` as the fusion reads it: the upsampled flow
    times ``flow_div``, its norm, and the brightness error of image 2
    warped by it (border padding)."""
    h, w = flow.shape[2:]
    scaled = upsampled(flow, h * scale_factor, w * scale_factor, flow_div)
    norm = torch.sqrt((scaled ** 2).sum(dim=1, keepdim=True))
    warped = flow_warp(img2, scaled, padding_mode="border")
    err = torch.sqrt(((img1 - warped) ** 2).sum(dim=1, keepdim=True))
    return scaled, norm, err


@dataclasses.dataclass(frozen=True)
class FlowNet2Config:
    flow_div: float = 20.0


class FlowNet2(nn.Module):
    """``forward`` → ``{"level3", "level2", "level1"}`` of the fusion, or
    with ``inference`` its full-resolution ``level1`` flow."""

    def __init__(self, config: FlowNet2Config = FlowNet2Config()):
        super().__init__()
        self.config = config
        self.flownetCSS = FlowNetCSS(FlowNetConfig(config.flow_div))
        self.flownetSD = FlowNetSD()
        self.fusion_encoder = FlowNetEncoder(
            11, (64, (64, 128), 128), (3, 3, 3), (1, 2, 2), (1, 2, 2))
        self.fusion_decoder = GenericFlowNetDecoder(
            (3, 2, 1), {3: 128, 2: 128, 1: 64}, {3: 32, 2: 16, 1: None},
            inter_channels={2: 32, 1: 16})

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        div = self.config.flow_div
        css = fusion_link(img1, img2,
                          self.flownetCSS(img1, img2)["level2"], div)
        sd = fusion_link(img1, img2, self.flownetSD(img1, img2)["level2"],
                         div)
        # img1 (3) + flows (2 + 2) + norms (1 + 1) + errors (1 + 1)
        x = torch.cat([img1, sd[0], css[0], sd[1], css[1], sd[2], css[2]],
                      dim=1)
        preds = self.fusion_decoder(self.fusion_encoder(x))
        if inference:
            return preds["level1"]
        return preds
