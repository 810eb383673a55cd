"""Perceptual towers for LaMa training and the LPIPS metric.

Port of ``followyourclick_tpu/inpaint/perceptual.py`` (the reference's
``saicinpainting/training/losses/perceptual.py`` ``ResNetPL`` and
``PerceptualLoss``, and ``evaluation/losses/lpips.py``). NCHW, inputs in
[0, 1].

The towers carry the released weights' names, so each loads with a strict
``load_state_dict``:

- :class:`DilatedResNet50Encoder`: the ade20k ``ResnetDilated`` encoder
  (``conv1``, ``bn1``, …, ``layer1.0.conv1``, ``layer1.0.downsample.0``);
  :func:`load_ade20k_resnet` drops a ``module.`` / ``encoder.`` prefix and
  the ``fc`` / ``avgpool`` / ``decoder`` keys;
- :class:`VGGFeatures`: torchvision's ``vgg*.features`` (``N.weight`` at
  the layer's index); :func:`load_vgg_features` drops a ``features.``
  prefix;
- :class:`LPIPS`: ``net`` (VGG16 features) and the lpips package's heads
  ``lins.N.model.1``; :func:`load_lpips` takes them as ``linN.*`` too.

The towers are frozen: :class:`FrozenBatchNorm2d` always folds its running
statistics into a scale and shift, whatever the module's mode.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """``(B, 3, H, W)`` RGB in [0, 1] → ImageNet-normalised."""
    mean = x.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = x.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    return (x - mean) / std


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state) that always applies its running
    statistics, folded: ``x·a + (bias − mean·a)``, ``a = weight /
    √(var + eps)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * a
        return x * a.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def _conv(cin, cout, kernel, stride=1, dilation=1):
    pad = dilation * (kernel // 2)
    return nn.Conv2d(cin, cout, kernel, stride, pad, dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride, dilation) → 1x1 (x4), ReLU after the residual
    add."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.relu = nn.ReLU()
        if downsample:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes * 4, 1, stride),
                FrozenBatchNorm2d(planes * 4))

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return self.relu(out + x)


# (planes, first block's stride, first block's dilation, later dilation):
# layer3 and layer4 lose their stride (ResnetDilated, dilate_scale 8)
_STAGES = ((64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 1, 2), (512, 1, 2, 4))


class DilatedResNet50Encoder(nn.Module):
    """ade20k ``resnet50dilated``: the deep stem (three 3x3 convs, the
    first at stride 2, then a 3x3 max-pool at stride 2) and bottleneck
    stages ``layers``; returns the four stages' outputs."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 3, 2), FrozenBatchNorm2d(64)
        self.conv2, self.bn2 = _conv(64, 64, 3), FrozenBatchNorm2d(64)
        self.conv3, self.bn3 = _conv(64, 128, 3), FrozenBatchNorm2d(128)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 128
        for i, ((planes, stride, dil0, dil), n) in enumerate(
                zip(_STAGES, layers)):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(
                    inplanes, planes, stride if b == 0 else 1,
                    dil0 if b == 0 else dil,
                    downsample=b == 0 and (stride != 1
                                           or inplanes != planes * 4)))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        x = self.maxpool(x)
        outs = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        return tuple(outs)


def load_ade20k_resnet(encoder: DilatedResNet50Encoder,
                       state_dict: Mapping[str, torch.Tensor]) -> None:
    """An ade20k ``ResnetDilated`` / ResNet-50 state dict, loaded strictly
    (``module.`` / ``encoder.`` prefixes dropped, ``fc``, ``avgpool`` and
    ``decoder`` keys skipped)."""
    sd = {}
    for k, v in state_dict.items():
        k = k.removeprefix("module.").removeprefix("encoder.")
        if not k.startswith(("fc.", "avgpool.", "decoder.")):
            sd[k] = v
    encoder.load_state_dict(sd, strict=True)


def resnet_pl_loss(encoder: DilatedResNet50Encoder, pred: torch.Tensor,
                   target: torch.Tensor, weight: float = 30.0
                   ) -> torch.Tensor:
    """ResNet-PL: the frozen encoder on the ImageNet-normalised pred and
    target, the per-stage feature MSEs summed, times ``weight`` (30 in the
    big-LaMa config)."""
    pf = encoder(imagenet_normalize(pred))
    tf = encoder(imagenet_normalize(target))
    return weight * sum(F.mse_loss(a, b) for a, b in zip(pf, tf))


# torchvision vgg*.features: conv widths and max-pools ("M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGGFeatures(nn.Sequential):
    """torchvision's VGG ``features`` (3x3 conv + ReLU, 2x2 pools), with
    the max-pools swapped for average pools (``use_avg_pool``), run up to
    ``max_layers`` layers (conv, ReLU and pool count one each, as the
    reference's ``vgg[:30]``); returns the taps: every ReLU's output
    (``tap="relu"``) or the last ReLU before each pool and at the end
    (``"pre_pool"``)."""

    def __init__(self, cfg: Sequence = VGG19_CFG,
                 max_layers: Optional[int] = None, use_avg_pool: bool = True,
                 tap: str = "relu"):
        layers, cin = [], 3
        for v in cfg:
            if v == "M":
                layers.append(nn.AvgPool2d(2, 2) if use_avg_pool
                              else nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        super().__init__(*layers)
        self.max_layers, self.tap = max_layers, tap

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, last = [], None
        for layer in list(self)[:self.max_layers]:
            if isinstance(layer, (nn.AvgPool2d, nn.MaxPool2d)) \
                    and self.tap == "pre_pool" and last is not None:
                taps.append(last)
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                last = x
                if self.tap == "relu":
                    taps.append(x)
        if self.tap == "pre_pool" and self.max_layers is None \
                and not isinstance(self[-1], (nn.AvgPool2d, nn.MaxPool2d)):
            taps.append(last)
        return taps


def perceptual_vgg() -> VGGFeatures:
    """The reference ``PerceptualLoss`` tower: VGG19 with average pools,
    its first 30 layers, a tap at every ReLU."""
    return VGGFeatures(VGG19_CFG, max_layers=30, use_avg_pool=True,
                       tap="relu")


def load_vgg_features(vgg: VGGFeatures,
                      state_dict: Mapping[str, torch.Tensor]) -> None:
    """torchvision ``vgg*.features`` weights (``N.weight``, or
    ``features.N.weight`` of the whole model's dict), loaded strictly."""
    vgg.load_state_dict({k.removeprefix("features."): v
                         for k, v in state_dict.items()
                         if not k.startswith("classifier.")}, strict=True)


def vgg_perceptual_partial_losses(vgg: VGGFeatures, pred: torch.Tensor,
                                  target: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None
                                  ) -> List[torch.Tensor]:
    """The reference ``PerceptualLoss.partial_losses``: at each tap of
    ``vgg`` (:func:`perceptual_vgg`) the per-sample MSE of the
    ImageNet-normalised pred and target, weighted by ``1 − mask`` resized
    (bilinear) to the tap; a list of ``(B,)`` losses."""
    from followyourclick_tpu_torch.inpaint.losses import resize_mask

    losses = []
    for fp, ft in zip(vgg(imagenet_normalize(pred)),
                      vgg(imagenet_normalize(target))):
        err = (fp - ft) ** 2
        if mask is not None:
            err = err * (1.0 - resize_mask(mask, fp.shape[-2:], "bilinear"))
        losses.append(err.mean(dim=tuple(range(1, err.ndim))))
    return losses


def vgg_perceptual_loss(vgg: VGGFeatures, pred: torch.Tensor,
                        target: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference ``PerceptualLoss.forward``: the partial losses
    summed, ``(B,)``."""
    return sum(vgg_perceptual_partial_losses(vgg, pred, target, mask))


# lpips' scaling layer
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
LPIPS_TAPS = (64, 128, 256, 512, 512)


class NetLinLayer(nn.Module):
    """lpips' 1x1 head (its dropout is off at evaluation)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0),
                                   nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """LPIPS (VGG16): the five pre-pool taps of the scaled inputs, each
    unit-normalised over channels (``+1e-10`` outside the root), the
    squared difference through its 1x1 head, the spatial mean, summed over
    the taps; ``(B,)``."""

    def __init__(self):
        super().__init__()
        self.net = VGGFeatures(VGG16_CFG, use_avg_pool=False, tap="pre_pool")
        self.lins = nn.ModuleList(NetLinLayer(c) for c in LPIPS_TAPS)

    def forward(self, pred: torch.Tensor, target: torch.Tensor):
        shift = pred.new_tensor(LPIPS_SHIFT).view(1, 3, 1, 1)
        scale = pred.new_tensor(LPIPS_SCALE).view(1, 3, 1, 1)

        def unit(t):
            return t / (t.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)

        total = 0.0
        for lin, a, b in zip(self.lins, self.net((2 * pred - 1 - shift)
                                                 / scale),
                             self.net((2 * target - 1 - shift) / scale)):
            total = total + lin((unit(a) - unit(b)) ** 2).mean(dim=(1, 2, 3))
        return total


def load_lpips(model: LPIPS, vgg_features_sd: Mapping[str, torch.Tensor],
               lins_sd: Mapping[str, torch.Tensor]) -> None:
    """torchvision ``vgg16.features`` weights and the lpips heads
    (``lins.N.model.1.weight`` or ``linN.model.1.weight``), loaded
    strictly."""
    load_vgg_features(model.net, vgg_features_sd)
    heads = {}
    for k, v in lins_sd.items():
        if k.startswith("lin") and not k.startswith("lins."):
            k = "lins." + k[3:]
        heads[k.removeprefix("lins.")] = v
    model.lins.load_state_dict(heads, strict=True)
