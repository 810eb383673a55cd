"""RAFT optical-flow estimator (and GMA, RAFT with one more head).

Port of ``followyourclick_tpu/flow/raft.py`` (mmflow ``RAFTEncoder``,
``RAFTDecoder``, ``GMADecoder`` and the ``RAFT`` estimator) at the
published 'Basic' widths (:class:`RAFTConfig`: 4 levels, radius 4, h =
cxt = 128, 12 iterations, SeqConv GRU), NCHW.

The modules carry mmflow's state-dict names (``encoder.res_layer1.0.bn1``,
``decoder.encoder.corr_net.0.conv``, ``decoder.gru.conv_z.0.conv``,
``decoder.flow_pred.predict_layer``, …), the names the JAX converter reads,
so an mmflow checkpoint loads with ``strict=True``
(``flow/convert.load_mmflow_raft_checkpoint``). GMA's heads take mmflow's
``decoder.attn.to_qk`` / ``decoder.aggregator.{to_v, gamma}``.

Norms, as the JAX modules: the feature encoder's is flax ``GroupNorm`` with
one channel a group, scale and bias (``nn.GroupNorm(C, C)``); the context
encoder's is :class:`models.layers.BatchNorm2d` (flax's running-statistics
update in training mode, the running ones in eval mode).

The decoder's ``lax.scan`` is a Python loop; the flow carried into each
iteration is detached, as JAX's ``stop_gradient``. With
``return_intermediate`` the forward returns every iteration's upsampled
flow ``(iters, B, 2, H, W)`` for ``sequence_loss``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.flow.ops import (
    convex_upsample,
    corr_lookup,
    correlation_pyramid,
)
from followyourclick_tpu_torch.models.layers import BatchNorm2d


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """mmflow ``configs/_base_/models/raft.py``; ``use_gma`` adds the
    global motion aggregation of ``configs/gma``."""

    num_levels: int = 4
    radius: int = 4
    h_channels: int = 128
    cxt_channels: int = 128
    iters: int = 12
    stem_channels: int = 64
    base_channels: Tuple[int, ...] = (64, 96, 128)
    strides: Tuple[int, ...] = (1, 2, 2)
    feat_channels: int = 256
    mask_channels: int = 64
    use_gma: bool = False
    gma_heads: int = 1


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "instance":
        return nn.GroupNorm(channels, channels, eps=1e-5)
    return BatchNorm2d(channels, eps=1e-5)


class BasicBlock(nn.Module):
    """ResNet basic block: conv3x3-norm-relu, conv3x3-norm, a projection
    shortcut where the stride or width changes, relu after the add."""

    def __init__(self, cin: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _norm(norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False),
                _norm(norm, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class RAFTEncoder(nn.Module):
    """Features at 1/8 resolution: a 7x7/2 stem, three stages of two basic
    blocks, a 1x1 out conv."""

    def __init__(self, out_channels: int, norm: str, cfg: RAFTConfig):
        super().__init__()
        self.conv1 = nn.Conv2d(3, cfg.stem_channels, 7, 2, 3)
        self.norm1 = _norm(norm, cfg.stem_channels)
        cin = cfg.stem_channels
        for i, (planes, stride) in enumerate(zip(cfg.base_channels,
                                                 cfg.strides)):
            setattr(self, f"res_layer{i + 1}", nn.Sequential(
                BasicBlock(cin, planes, stride, norm),
                BasicBlock(planes, planes, 1, norm)))
            cin = planes
        self.num_stages = len(cfg.base_channels)
        self.conv2 = nn.Conv2d(cin, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        for i in range(self.num_stages):
            x = getattr(self, f"res_layer{i + 1}")(x)
        return self.conv2(x)


class ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm: a conv (as ``.conv``), then the
    activation when ``act``."""

    def __init__(self, cin: int, cout: int, kernel, padding, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x) if self.act else x


class MotionEncoder(nn.Module):
    """Correlation and flow features fused to 128 channels (126 + the
    flow)."""

    def __init__(self, corr_channels: int):
        super().__init__()
        self.corr_net = nn.Sequential(ConvModule(corr_channels, 256, 1, 0),
                                      ConvModule(256, 192, 3, 1))
        self.flow_net = nn.Sequential(ConvModule(2, 128, 7, 3),
                                      ConvModule(128, 64, 3, 1))
        self.out_net = nn.Sequential(ConvModule(192 + 64, 126, 3, 1))

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        out = self.out_net(torch.cat([self.corr_net(corr),
                                      self.flow_net(flow)], dim=1))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    """'SeqConv' GRU: a (1, 5) pass, then a (5, 1) pass."""

    def __init__(self, h_channels: int, x_channels: int):
        super().__init__()
        cin = h_channels + x_channels
        shapes = (((1, 5), (0, 2)), ((5, 1), (2, 0)))
        for gate in ("z", "r", "q"):
            setattr(self, f"conv_{gate}", nn.ModuleList(
                ConvModule(cin, h_channels, k, p, act=False)
                for k, p in shapes))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(self.conv_z[i](hx))
            r = torch.sigmoid(self.conv_r[i](hx))
            q = torch.tanh(self.conv_q[i](torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class GMAAttention(nn.Module):
    """Content self-similarity of the context features, softmax over all
    positions: ``(B, heads, HW, HW)``."""

    def __init__(self, cxt_channels: int, heads: int, head_channels: int):
        super().__init__()
        self.heads, self.head_channels = heads, head_channels
        self.to_qk = nn.Conv2d(cxt_channels, 2 * heads * head_channels, 1)

    def forward(self, cxt: torch.Tensor) -> torch.Tensor:
        B, _, H, W = cxt.shape
        q, k = self.to_qk(cxt).reshape(
            B, 2, self.heads, self.head_channels, H * W).unbind(1)
        q = q * self.head_channels ** -0.5
        return torch.softmax(q.transpose(2, 3) @ k, dim=-1)


class GMAAggregate(nn.Module):
    """Attention-weighted aggregation of the motion features, added back
    through a gate ``gamma`` that starts at zero."""

    def __init__(self, in_channels: int, heads: int, head_channels: int):
        super().__init__()
        self.heads, self.head_channels = heads, head_channels
        inner = heads * head_channels
        self.to_v = nn.Conv2d(in_channels, inner, 1, bias=False)
        self.project = None if inner == in_channels else \
            nn.Conv2d(inner, in_channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        v = self.to_v(x).reshape(B, self.heads, self.head_channels, H * W)
        out = (v @ attn.transpose(2, 3)).reshape(B, -1, H, W)
        if self.project is not None:
            out = self.project(out)
        return x + self.gamma * out


class XHead(nn.Module):
    """conv3x3 → feat_channels (ReLU), then the predict conv (3x3 for the
    flow, 1x1 for the upsampling mask)."""

    def __init__(self, cin: int, feat_channels: int, cout: int, kind: str):
        super().__init__()
        self.layers = nn.Sequential(ConvModule(cin, feat_channels, 3, 1))
        kernel = 3 if kind == "flow" else 1
        self.predict_layer = nn.Conv2d(feat_channels, cout, kernel,
                                       padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict_layer(self.layers(x))


class RAFTDecoder(nn.Module):
    """The iterative update: correlation lookup → motion features (→ GMA)
    → GRU → flow delta; convex upsampling by the mask head."""

    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = MotionEncoder(
            cfg.num_levels * (2 * cfg.radius + 1) ** 2)
        x_channels = cfg.cxt_channels + 128
        if cfg.use_gma:
            self.attn = GMAAttention(cfg.cxt_channels, cfg.gma_heads,
                                     cfg.cxt_channels)
            self.aggregator = GMAAggregate(128, cfg.gma_heads, 128)
            x_channels += 128
        self.gru = ConvGRU(cfg.h_channels, x_channels)
        self.scale = 2 ** (cfg.num_levels - 1)
        self.flow_pred = XHead(cfg.h_channels, cfg.feat_channels, 2, "flow")
        self.mask_pred = XHead(cfg.h_channels, cfg.feat_channels,
                               9 * self.scale ** 2, "mask")

    def upsample(self, flow: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        # mmflow scales the mask logits by 0.25 (raft_decoder.py:444)
        return convex_upsample(flow, 0.25 * self.mask_pred(h), self.scale)

    def forward(self, feat1, feat2, flow, h, cxt, iters: int,
                return_intermediate: bool = False):
        cfg = self.cfg
        pyramid = correlation_pyramid(feat1, feat2, cfg.num_levels)
        attn = self.attn(cxt) if cfg.use_gma else None
        ups = []
        for _ in range(iters):
            flow = flow.detach()
            motion = self.encoder(corr_lookup(pyramid, flow, cfg.radius),
                                  flow)
            x = [cxt, motion]
            if attn is not None:
                x.append(self.aggregator(attn, motion))
            h = self.gru(h, torch.cat(x, dim=1))
            flow = flow + self.flow_pred(h)
            if return_intermediate:
                ups.append(self.upsample(flow, h))
        if return_intermediate:
            return torch.stack(ups)
        return self.upsample(flow, h)


class RAFT(nn.Module):
    """The estimator: the feature encoder (shared, instance norm) on both
    frames, the context encoder (BN) on the first, split into tanh(hidden)
    and relu(context), then the decoder. Images ``(B, 3, H, W)``,
    normalised as the data pipeline does, H and W multiples of 8; the flow
    ``(B, 2, H, W)`` in pixels."""

    def __init__(self, config: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.config = config
        self.encoder = RAFTEncoder(256, "instance", config)
        self.context = RAFTEncoder(config.h_channels + config.cxt_channels,
                                   "batch", config)
        self.decoder = RAFTDecoder(config)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                iters: Optional[int] = None,
                flow_init: Optional[torch.Tensor] = None,
                return_intermediate: bool = False) -> torch.Tensor:
        cfg = self.config
        # one pass over both frames: the instance norm is per sample
        feat1, feat2 = self.encoder(torch.cat([img1, img2])).chunk(2)
        cxt = self.context(img1)
        h = torch.tanh(cxt[:, :cfg.h_channels])
        cxt = F.relu(cxt[:, cfg.h_channels:])
        if flow_init is None:
            B, _, H8, W8 = feat1.shape
            flow_init = feat1.new_zeros(B, 2, H8, W8)
        return self.decoder(feat1, feat2, flow_init, h, cxt,
                            cfg.iters if iters is None else iters,
                            return_intermediate)
