"""LaMa FFC-ResNet inpainting generator.

Port of ``followyourclick_tpu/inpaint/lama.py`` (the reference's
``saicinpainting/training/modules/ffc.py``: ``FourierUnit``,
``SpectralTransform``, ``FFC``, ``FFC_BN_ACT``, ``FFCResnetBlock``,
``FFCResNetGenerator``) with the released big-LaMa constants
(:class:`LamaConfig`: RGB + mask in, ngf 64, 3 downsamples, 18 FFC blocks at
ratio 0.75, sigmoid out).

NCHW. The modules keep the reference's torch names, so a released
``best.ckpt`` loads strictly: ``FFCResNetGenerator.model`` is the
reference ``nn.Sequential`` — index 0 the ReflectionPad, 1 the stem, then
the downsamples, the blocks, ``ConcatTupleLayer``, (ConvTranspose2d, BN,
ReLU) per upsample, the pad, the head conv and the output activation.
Absent branches (a ratio of 0) hold no module where the reference holds an
``nn.Identity``; the local / global pair travels as a tuple whose global
half is None until the last downsample splits it off.

The spectral path runs ``torch.fft.rfft2`` / ``irfft2`` over (H, W) with
``norm="ortho"`` in fp32; real and imaginary parts stack channel-major with
real / imag innermost, as both the reference and the JAX package lay them.

:class:`BatchNorm2d` (``models/layers.py``, shared with RAFT's context
encoder) is ``nn.BatchNorm2d`` with flax's running-statistics update in
training mode (momentum 0.1 on the *biased* batch variance, where torch's
own takes the unbiased one), so a train step moves the statistics as the
JAX trainer does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from followyourclick_tpu_torch.models.layers import BN_STATS, BatchNorm2d
from followyourclick_tpu_torch.utils.backend_flags import checked_precision
from followyourclick_tpu_torch.utils.seeded_init import seeded_init_


@dataclasses.dataclass(frozen=True)
class LamaConfig:
    input_nc: int = 4
    output_nc: int = 3
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 18
    max_features: int = 1024
    resnet_ratio: float = 0.75
    enable_lfu: bool = False
    add_out_act: str = "sigmoid"
    dtype: torch.dtype = torch.float32


def _conv(cin, cout, kernel, stride=1, padding=0, dilation=1):
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation,
                     bias=False, padding_mode="reflect")


class FourierUnit(nn.Module):
    """rfft2 → (real, imag) as channels → 1x1 conv + BN + ReLU → irfft2."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(in_channels * 2, out_channels * 2, 1,
                                    bias=False)
        self.bn = BatchNorm2d(out_channels * 2)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        ffted = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
        f = torch.stack((ffted.real, ffted.imag), dim=2)   # (B, C, 2, H, Wf)
        f = f.reshape(b, c * 2, h, w // 2 + 1).to(x.dtype)
        f = self.relu(self.bn(self.conv_layer(f)))
        f = f.reshape(b, -1, 2, h, w // 2 + 1).float()
        out = torch.fft.irfft2(torch.complex(f[:, :, 0], f[:, :, 1]),
                               s=(h, w), dim=(-2, -1), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    """(AvgPool2d(2) at stride 2) → 1x1 conv + BN + ReLU → FourierUnit (+
    the local Fourier unit) → residual → 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 enable_lfu: bool = False):
        super().__init__()
        self.enable_lfu = enable_lfu
        self.downsample = nn.AvgPool2d(2, 2) if stride == 2 else nn.Identity()
        half = out_channels // 2
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_channels, half, 1, bias=False), BatchNorm2d(half),
            nn.ReLU())
        self.fu = FourierUnit(half, half)
        if enable_lfu:
            self.lfu = FourierUnit(half, half)
        self.conv2 = nn.Conv2d(half, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.downsample(x))
        out = self.fu(x)
        if self.enable_lfu:
            # a quarter of the channels, split in H, then in W, into channels
            xs = x[:, :x.shape[1] // 4]
            xs = torch.cat(torch.chunk(xs, 2, dim=2), dim=1)
            xs = torch.cat(torch.chunk(xs, 2, dim=3), dim=1)
            out = out + self.lfu(xs).repeat(1, 1, 2, 2)
        return self.conv2(x + out)


class FFC(nn.Module):
    """Local / global split convolution: ``int(channels · ratio)`` global
    channels, reflect-padded convs between and within the local halves, the
    spectral transform global to global."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float, ratio_gout: float, stride: int = 1,
                 padding: int = 0, dilation: int = 1,
                 enable_lfu: bool = False):
        super().__init__()
        in_cg = int(in_channels * ratio_gin)
        in_cl = in_channels - in_cg
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg
        args = (kernel_size, stride, padding, dilation)
        if in_cl and out_cl:
            self.convl2l = _conv(in_cl, out_cl, *args)
        if in_cl and out_cg:
            self.convl2g = _conv(in_cl, out_cg, *args)
        if in_cg and out_cl:
            self.convg2l = _conv(in_cg, out_cl, *args)
        if in_cg and out_cg:
            self.convg2g = SpectralTransform(in_cg, out_cg, stride,
                                             enable_lfu)
        self.has_l, self.has_g = bool(out_cl), bool(out_cg)

    def _sum(self, pairs):
        terms = [getattr(self, name)(x) for name, x in pairs
                 if hasattr(self, name)]
        return sum(terms[1:], terms[0]) if terms else None

    def forward(self, x_l, x_g):
        out_l = self._sum((("convl2l", x_l), ("convg2l", x_g))) \
            if self.has_l else None
        out_g = self._sum((("convl2g", x_l), ("convg2g", x_g))) \
            if self.has_g else None
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    """FFC, then BN + ReLU on each branch it outputs. Takes a tensor (all
    local) or a (local, global) tuple; returns the tuple."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float, ratio_gout: float, stride: int = 1,
                 padding: int = 0, dilation: int = 1,
                 enable_lfu: bool = False):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel_size, ratio_gin,
                       ratio_gout, stride, padding, dilation, enable_lfu)
        global_channels = int(out_channels * ratio_gout)
        if ratio_gout != 1:
            self.bn_l = BatchNorm2d(out_channels - global_channels)
        if ratio_gout != 0:
            self.bn_g = BatchNorm2d(global_channels)
        self.act = nn.ReLU()

    def forward(self, x):
        x_l, x_g = x if isinstance(x, tuple) else (x, None)
        x_l, x_g = self.ffc(x_l, x_g)
        if x_l is not None:
            x_l = self.act(self.bn_l(x_l))
        if x_g is not None:
            x_g = self.act(self.bn_g(x_g))
        return x_l, x_g


class FFCResnetBlock(nn.Module):
    """Two FFC_BN_ACT with a residual on each branch."""

    def __init__(self, dim: int, ratio: float, dilation: int = 1,
                 enable_lfu: bool = False):
        super().__init__()
        args = (dim, dim, 3, ratio, ratio, 1, dilation, dilation, enable_lfu)
        self.conv1 = FFC_BN_ACT(*args)
        self.conv2 = FFC_BN_ACT(*args)

    def forward(self, x):
        id_l, id_g = x
        x_l, x_g = self.conv2(self.conv1(x))
        return id_l + x_l, id_g + x_g


class ConcatTupleLayer(nn.Module):
    """(local, global) → one tensor, channels concatenated."""

    def forward(self, x):
        x_l, x_g = x
        return x_l if x_g is None else torch.cat((x_l, x_g), dim=1)


class FFCResNetGenerator(nn.Module):
    """Reflect-pad 7x7 stem → stride-2 downsamples (the last one splits off
    the global branch) → FFC ResNet blocks → concat → transposed-conv
    upsamples → reflect-pad 7x7 head → output activation."""

    def __init__(self, config: LamaConfig = LamaConfig()):
        super().__init__()
        cfg = self.config = config
        lfu = cfg.enable_lfu
        model = [nn.ReflectionPad2d(3),
                 FFC_BN_ACT(cfg.input_nc, cfg.ngf, 7, 0.0, 0.0,
                            enable_lfu=lfu)]
        for i in range(cfg.n_downsampling):
            mult = 2 ** i
            gout = cfg.resnet_ratio if i == cfg.n_downsampling - 1 else 0.0
            model.append(FFC_BN_ACT(
                min(cfg.max_features, cfg.ngf * mult),
                min(cfg.max_features, cfg.ngf * mult * 2), 3, 0.0, gout,
                stride=2, padding=1, enable_lfu=lfu))
        feats = min(cfg.max_features, cfg.ngf * 2 ** cfg.n_downsampling)
        model += [FFCResnetBlock(feats, cfg.resnet_ratio, enable_lfu=lfu)
                  for _ in range(cfg.n_blocks)]
        model.append(ConcatTupleLayer())
        for i in range(cfg.n_downsampling):
            mult = 2 ** (cfg.n_downsampling - i)
            out = min(cfg.max_features, int(cfg.ngf * mult / 2))
            model += [nn.ConvTranspose2d(min(cfg.max_features, cfg.ngf * mult),
                                         out, 3, stride=2, padding=1,
                                         output_padding=1),
                      BatchNorm2d(out), nn.ReLU()]
        model += [nn.ReflectionPad2d(3), nn.Conv2d(cfg.ngf, cfg.output_nc, 7)]
        if cfg.add_out_act == "sigmoid":
            model.append(nn.Sigmoid())
        elif cfg.add_out_act == "tanh":
            model.append(nn.Tanh())
        self.model = nn.Sequential(*model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def build_generator(config: LamaConfig = LamaConfig(), device="cuda",
                    generator: Optional[torch.Generator] = None,
                    state_dict: Optional[dict] = None) -> FFCResNetGenerator:
    """A generator on ``device`` in ``config.dtype`` (eval mode), built on
    the meta device and filled from ``state_dict`` (the reference's names,
    strict) or else with seeded values, BN running statistics included
    (``utils/seeded_init``), from ``generator`` (a CPU generator seeded 0
    when none is given)."""
    with torch.device("meta"):
        model = FFCResNetGenerator(config)
    model = model.to_empty(device=device)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.num_batches_tracked.zero_()
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        seeded_init_(model, generator or torch.Generator().manual_seed(0),
                     buffers=BN_STATS)
    return model.to(config.dtype).eval()


def inpaint(generator: FFCResNetGenerator, image: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) image in [0, 1] and (B, 1, H, W) {0, 1} mask →
    ``mask·pred + (1 − mask)·image``, the generator run on the masked image
    and the mask."""
    pred = generator(torch.cat([image * (1.0 - mask), mask], dim=1))
    return mask * pred + (1.0 - mask) * image


class LamaInpainter:
    """Image in, image out (the reference ``inpaint_img_with_lama``): (H, W,
    3) uint8 RGB and a mask (nonzero = hole) → uint8 RGB with the hole
    filled; the image is padded to a multiple of 8 (``np.pad`` symmetric)
    and cropped back; the output truncates ``clip(out·255)`` to uint8."""

    def __init__(self, model: FFCResNetGenerator, device=None):
        self.model = model
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device

    @staticmethod
    def init_random(config: LamaConfig = LamaConfig(), seed: int = 0,
                    device="cuda") -> "LamaInpainter":
        """Seeded random weights drawn on ``device``."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return LamaInpainter(build_generator(config, device, gen), device)

    @torch.inference_mode()
    @checked_precision()
    def __call__(self, image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        assert image.ndim == 3 and image.shape[2] == 3
        h, w = image.shape[:2]
        ph, pw = (-h) % 8, (-w) % 8
        img = image.astype(np.float32) / 255.0
        m = (np.asarray(mask) > 0).astype(np.float32)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="symmetric")
        m = np.pad(m, ((0, ph), (0, pw)), mode="symmetric")
        dt = self.model.config.dtype
        x = torch.from_numpy(img).to(self.device, dt).permute(2, 0, 1)[None]
        mt = torch.from_numpy(m).to(self.device, dt)[None, None]
        out = inpaint(self.model, x, mt)[0].permute(1, 2, 0)[:h, :w]
        out = out.float().cpu().numpy()
        return np.clip(out * 255.0, 0, 255).astype(np.uint8)
