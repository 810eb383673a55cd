"""IRR-PWC: iterative residual refinement with shared decoders,
bidirectional flow and occlusion.

Port of ``followyourclick_tpu/flow/irrpwc.py`` (mmflow
``irrpwc_decoder.py`` and ``irr_refine.py``), NCHW. The 'Small' PWC
pyramid (two convs a level) on both images; at levels 6 → 2 a correlation
each way (scaled by the channel count) and a 1x1 reduction of every level
to 32 channels, so that ONE flow decoder, ONE occlusion decoder and their
context networks serve every level and both directions; a local-conv
bilateral refinement (softmax(−k²) kernels over replicate-padded 3x3
neighbourhoods) of the flows and occlusions; at levels 1 and 0 the flow is
only upsampled and the occlusion refined by :class:`OccShuffleUpsample`.

``forward`` returns ``(flow_preds, occ_preds)``: ``{"flow_fw" | "flow_bw":
{"level<l>": [raw, refined]}}`` for levels 6 → 2 and ``[flow]`` for 1
and 0, the flows at image scale over ``flow_div`` (the EPE loss's
convention), and the occlusion logits alike under ``occ_fw`` / ``occ_bw``;
with ``inference`` the level-0 forward flow in pixels.

Submodules carry the JAX module names (``flow_decoders.dense0``,
``conv1x1_level5``, ``occ_shuffle_upsample.res_conv``, …).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.flow.ops import (
    bilinear_resize,
    flow_warp,
    local_correlation,
)
from followyourclick_tpu_torch.flow.pwcnet import (
    ContextNet,
    DenseBlock,
    PWCNetConfig,
    PWCNetEncoder,
    conv,
    corr_channels,
    leaky,
    native_convolutions,
)


def _scale_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """mmflow ``_scale_flow``: the values rescaled by the size ratio, then
    the map resized."""
    h0, w0 = flow.shape[2:]
    scale = flow.new_tensor([w / w0, h / h0])[:, None, None]
    return bilinear_resize(flow * scale, h, w)


def _unfold3x3_replicate(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W)`` → ``(B, C, 9, H, W)`` replicate-padded 3x3
    neighbourhoods in row-major order."""
    H, W = x.shape[2:]
    p = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return torch.stack([p[:, :, dy:dy + H, dx:dx + W] for dy in range(3)
                        for dx in range(3)], dim=2)


class IRRDenseDecoder(DenseBlock):
    """The shared dense decoder and its head: ``(feat, prediction)``."""

    def __init__(self, cin: int, out_channels: int,
                 densefeat_channels: Tuple[int, ...] = (128, 128, 96, 64,
                                                        32)):
        super().__init__(cin, densefeat_channels)
        self.predict = conv(self.out_channels, out_channels)

    def forward(self, x: torch.Tensor):
        x = self.dense(x)
        return x, self.predict(x)


class LocalConvRefine(nn.Module):
    """``FlowRefine`` / ``OccRefine``: convs of the guide ``feat`` give 3x3
    kernel logits k; softmax(−k²) weighs each target channel's
    neighbourhood."""

    def __init__(self, cin: int,
                 feat_channels: Tuple[int, ...] = (128, 128, 64, 64, 32,
                                                   32)):
        super().__init__()
        for i, ch in enumerate(feat_channels):
            self.add_module(f"conv{i}", conv(cin, ch))
            cin = ch
        self.num = len(feat_channels)
        self.kernel = conv(cin, 9)

    def forward(self, feat: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            feat = leaky(getattr(self, f"conv{i}")(feat))
        k = leaky(self.kernel(feat))
        k = torch.softmax(-(k.float() ** 2), dim=1)
        out = (k[:, None] * _unfold3x3_replicate(targets)).sum(dim=2)
        return out.to(targets.dtype)


class OccShuffleUpsample(nn.Module):
    """The occlusion refiner of the finest levels (mmflow
    ``irr_refine.py:255-373``)."""

    def __init__(self, feat_channels: int = 32, infeat_channels: int = 16):
        super().__init__()
        self.conv_1x1 = conv(infeat_channels, 3, 1)
        self.init_conv = conv(11, feat_channels)
        self.res_conv = conv(feat_channels, feat_channels)
        self.res_end_conv = conv(feat_channels, feat_channels)
        self.out_conv = conv(feat_channels, 1)

    def forward(self, occ, feat1, feat2, flow_f, flow_b, flow_div: float,
                H_img: int, W_img: int):
        feat2_warp = flow_warp(feat2, flow_f)
        h0, w0 = flow_f.shape[2:]
        scale = flow_f.new_tensor([W_img / w0, H_img / h0])[:, None, None] \
            / flow_div
        flow_b_warp = flow_warp(flow_b * scale, flow_f)
        if feat1.shape[1] > 3:
            feat1 = leaky(self.conv_1x1(feat1))
            feat2_warp = leaky(self.conv_1x1(feat2_warp))
        x = torch.cat([occ, feat1, feat2_warp, flow_f * scale, flow_b_warp],
                      dim=1)
        feat_init = leaky(self.init_conv(x))
        feat_res = feat_init
        for _ in range(3):
            feat_res = feat_res + self.res_conv(feat_res) * 0.1
        feat_init = feat_init + leaky(self.res_end_conv(feat_res))
        return leaky(self.out_conv(feat_init)) + occ


@dataclasses.dataclass(frozen=True)
class IRRPWCConfig:
    pyramid_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 196)
    corr_feat_channels: int = 32
    densefeat_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    refine_channels: Tuple[int, ...] = (128, 128, 64, 64, 32, 32)
    max_displacement: int = 4
    flow_div: float = 20.0


Preds = Dict[str, Dict[str, List[torch.Tensor]]]


class IRRPWC(nn.Module):
    """Bidirectional flow and occlusion, levels 6 → 0, shared decoders."""

    def __init__(self, config: IRRPWCConfig = IRRPWCConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = PWCNetEncoder(PWCNetConfig(
            pyramid_channels=cfg.pyramid_channels, encoder_num_convs=2))
        nc = corr_channels(cfg.max_displacement)
        cf = cfg.corr_feat_channels
        self.flow_decoders = IRRDenseDecoder(nc + cf + 2, 2,
                                             cfg.densefeat_channels)
        self.occ_decoders = IRRDenseDecoder(nc + cf + 1, 1,
                                            cfg.densefeat_channels)
        self.flow_post_processor = ContextNet(
            self.flow_decoders.out_channels + 2)
        self.occ_post_processor = ContextNet(
            self.occ_decoders.out_channels + 1, out_channels=1)
        self.flow_refine = LocalConvRefine(3 + cf, cfg.refine_channels)
        self.occ_refine = LocalConvRefine(1 + 2 * cf, cfg.refine_channels)
        self.occ_shuffle_upsample = OccShuffleUpsample(
            infeat_channels=cfg.pyramid_channels[0])
        for level in (6, 5, 4, 3, 2):
            ch = cfg.pyramid_channels[level - 1]
            if ch != cf:
                self.add_module(f"conv1x1_level{level}", conv(ch, cf, 1))

    def _corr_block(self, level, f1, f2, flow_f, flow_b):
        d = self.config.max_displacement
        f1w = f1 if flow_f is None else flow_warp(f1, flow_b)
        f2w = f2 if flow_f is None else flow_warp(f2, flow_f)
        corr_f = leaky(local_correlation(f1, f2w, d, scaled=True))
        corr_b = leaky(local_correlation(f2, f1w, d, scaled=True))
        if f1.shape[1] != self.config.corr_feat_channels:
            proj = getattr(self, f"conv1x1_level{level}")
            f1, f2 = leaky(proj(f1)), leaky(proj(f2))
        return corr_f, f1, corr_b, f2

    def _refine_flow(self, a_img, b_img, fr, flow):
        flow = flow.detach()
        diff = torch.sqrt(((a_img - flow_warp(b_img, flow)) ** 2).sum(
            dim=1, keepdim=True))
        nomean = flow - flow.mean(dim=(2, 3), keepdim=True)
        return self.flow_refine(torch.cat([nomean, diff, fr], dim=1), flow)

    def _refine_occ(self, fa, fb, occ, flow):
        occ = occ.detach()
        diff = fa - flow_warp(fb, flow)
        return self.occ_refine(torch.cat([occ, fa, diff], dim=1), occ)

    @native_convolutions
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                inference: bool = False):
        cfg = self.config
        feat1 = self.encoder(img1)
        feat2 = self.encoder(img2)
        feat1[0], feat2[0] = img1, img2
        H_img, W_img = img1.shape[2:]

        def as_gt(flow):
            h0, w0 = flow.shape[2:]
            return flow * flow.new_tensor(
                [W_img / w0, H_img / h0])[:, None, None] / cfg.flow_div

        flow_preds: Preds = {"flow_fw": {}, "flow_bw": {}}
        occ_preds: Preds = {"occ_fw": {}, "occ_bw": {}}
        flow_fw = flow_bw = occ_fw = occ_bw = None
        for level in (6, 5, 4, 3, 2, 1, 0):
            f1, f2 = feat1[level], feat2[level]
            B = f1.shape[0]
            h, w = f1.shape[2:]
            if level == 6:
                flow_fw = f1.new_zeros(B, 2, h, w)
                flow_bw = f1.new_zeros(B, 2, h, w)
                occ_fw = f1.new_zeros(B, 1, h, w)
                occ_bw = f1.new_zeros(B, 1, h, w)
            else:
                flow_fw = _scale_flow(flow_fw, h, w)
                flow_bw = _scale_flow(flow_bw, h, w)
                if level > 1:
                    occ_fw = bilinear_resize(occ_fw, h, w)
                    occ_bw = bilinear_resize(occ_bw, h, w)
            name = f"level{level}"
            if level <= 1:  # the occlusion-refined levels
                flow_preds["flow_fw"][name] = [as_gt(flow_fw)]
                flow_preds["flow_bw"][name] = [as_gt(flow_bw)]
                occ_fw = F.interpolate(occ_fw, (h, w), mode="nearest-exact")
                occ_bw = F.interpolate(occ_bw, (h, w), mode="nearest-exact")
                up = self.occ_shuffle_upsample
                occ_fw = up(occ_fw, f1, f2, flow_fw, flow_bw, cfg.flow_div,
                            H_img, W_img)
                occ_bw = up(occ_bw, f2, f1, flow_bw, flow_fw, cfg.flow_div,
                            H_img, W_img)
                occ_preds["occ_fw"][name] = [occ_fw]
                occ_preds["occ_bw"][name] = [occ_bw]
                continue

            corr_f, f1r, corr_b, f2r = self._corr_block(
                level, f1, f2, None if level == 6 else flow_fw,
                None if level == 6 else flow_bw)
            feat_f, res_f = self.flow_decoders(
                torch.cat([corr_f, f1r, flow_fw], dim=1))
            feat_b, res_b = self.flow_decoders(
                torch.cat([corr_b, f2r, flow_bw], dim=1))
            flow_fw = flow_fw + res_f
            flow_bw = flow_bw + res_b
            flow_fw = flow_fw + self.flow_post_processor(
                torch.cat([feat_f, flow_fw], dim=1))
            flow_bw = flow_bw + self.flow_post_processor(
                torch.cat([feat_b, flow_bw], dim=1))

            feat_of, ores_f = self.occ_decoders(
                torch.cat([corr_f, f1r, occ_fw], dim=1))
            feat_ob, ores_b = self.occ_decoders(
                torch.cat([corr_b, f2r, occ_bw], dim=1))
            occ_fw = occ_fw + ores_f
            occ_bw = occ_bw + ores_b
            occ_fw = occ_fw + self.occ_post_processor(
                torch.cat([feat_of, occ_fw], dim=1))
            occ_bw = occ_bw + self.occ_post_processor(
                torch.cat([feat_ob, occ_bw], dim=1))

            # bilateral refinement of the detached flows and occlusions
            s_img1 = bilinear_resize(img1, h, w)
            s_img2 = bilinear_resize(img2, h, w)
            flow_ref_f = self._refine_flow(s_img1, s_img2, f1r, flow_fw)
            flow_ref_b = self._refine_flow(s_img2, s_img1, f2r, flow_bw)
            occ_ref_f = self._refine_occ(f1r, f2r, occ_fw, flow_ref_f)
            occ_ref_b = self._refine_occ(f2r, f1r, occ_bw, flow_ref_b)

            flow_preds["flow_fw"][name] = [as_gt(flow_fw), as_gt(flow_ref_f)]
            flow_preds["flow_bw"][name] = [as_gt(flow_bw), as_gt(flow_ref_b)]
            occ_preds["occ_fw"][name] = [occ_fw, occ_ref_f]
            occ_preds["occ_bw"][name] = [occ_bw, occ_ref_b]
            flow_fw, flow_bw = flow_ref_f, flow_ref_b
            occ_fw, occ_bw = occ_ref_f, occ_ref_b

        if inference:
            fine = flow_preds["flow_fw"]["level0"][0]
            return bilinear_resize(fine, H_img, W_img) * cfg.flow_div
        return flow_preds, occ_preds
