"""LaMa training losses and evaluation metrics.

Port of ``followyourclick_tpu/inpaint/losses.py`` (the reference's
``saicinpainting/training/losses/feature_matching.py``, ``adversarial.py``
``NonSaturatingWithR1``, ``modules/pix2pixhd.py`` ``NLayerDiscriminator``
and ``evaluation/losses/ssim.py``). NCHW; masks are ``(B, 1, H, W)`` with 1
in the hole.

Mask resizing follows ``jax.image.resize``: bilinear antialiases on a
shrink (``antialias=True``); nearest takes half-pixel centres, which is
``F.interpolate(mode="nearest-exact")`` (``"nearest"`` floors the source
index and picks other rows).

:class:`NLayerDiscriminator` keeps the reference's names (``model{n}``
``nn.Sequential`` stages: conv, BN, LeakyReLU) and returns the patch
logits and the stages' outputs, the taps of the feature-matching loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def masked_l1_loss(pred, target, mask, weight_known=10.0,
                   weight_missing=0.0):
    """Per-pixel L1 weighted ``weight_missing`` in the hole and
    ``weight_known`` outside it, mean over everything."""
    weights = mask * weight_missing + (1 - mask) * weight_known
    return (weights * (pred - target).abs()).mean()


def masked_l2_loss(pred, target, mask, weight_known=10.0,
                   weight_missing=0.0):
    weights = mask * weight_missing + (1 - mask) * weight_known
    return (weights * (pred - target) ** 2).mean()


def resize_mask(mask: torch.Tensor, size, method: str) -> torch.Tensor:
    """``jax.image.resize`` of a ``(B, 1, H, W)`` mask to ``size`` (h, w):
    ``"bilinear"`` (antialiased on a shrink) or ``"nearest"`` (half-pixel
    centres)."""
    if method == "nearest":
        return F.interpolate(mask, size=tuple(size), mode="nearest-exact")
    return F.interpolate(mask, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def feature_matching_loss(fake_features: Sequence[torch.Tensor],
                          target_features: Sequence[torch.Tensor],
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean over the taps of each tap's MSE; with a mask, errors weighted
    by ``1 − mask`` resized (bilinear) to the tap."""
    total = 0.0
    for fake, target in zip(fake_features, target_features):
        err = (fake - target) ** 2
        if mask is not None:
            err = err * (1 - resize_mask(mask, fake.shape[-2:], "bilinear"))
        total = total + err.mean()
    return total / len(fake_features)


def generator_nsgan_loss(discr_fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss: ``softplus(−D(fake)).mean()``."""
    return F.softplus(-discr_fake_pred).mean()


def discriminator_nsgan_r1_loss(
        discriminator: Callable, real_batch: torch.Tensor,
        fake_batch: torch.Tensor, mask: Optional[torch.Tensor] = None,
        gp_coef: float = 0.001, mask_as_fake_target: bool = True
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``softplus(−D(real)) + gp_coef·R1 + softplus(D(fake))``, R1 the
    batch mean of each sample's ``‖∇ₓ ΣD(real)‖²``, taken with
    ``create_graph`` so the penalty reaches D's parameters. With
    ``mask_as_fake_target`` the fake term holds in the hole (the mask
    resized nearest to the logits) and the rest of the fake is scored as
    real."""
    real = real_batch.detach().requires_grad_(True)
    real_pred, _ = discriminator(real)
    (grad,) = torch.autograd.grad(real_pred.sum(), real, create_graph=True)
    r1 = grad.reshape(grad.shape[0], -1).pow(2).sum(1).mean()
    real_loss = F.softplus(-real_pred)
    fake_pred, _ = discriminator(fake_batch)
    fake_loss = F.softplus(fake_pred)
    if mask is not None and mask_as_fake_target:
        m = resize_mask(mask, fake_pred.shape[-2:], "nearest")
        fake_loss = fake_loss * m + (1 - m) * F.softplus(-fake_pred)
    loss = real_loss.mean() + gp_coef * r1 + fake_loss.mean()
    return loss, {"discr_real_out": real_pred.mean(),
                  "discr_fake_out": fake_pred.mean(), "r1": r1}


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4x4 convs (``padding=2``) at stride 2, then one at stride
    1, each but the first followed by BN, all by LeakyReLU(0.2); then the
    1-channel logit conv. ``forward`` returns (logits, the stages'
    outputs)."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers

        def stage(cin, cout, stride, norm=True):
            layers = [nn.Conv2d(cin, cout, 4, stride, 2)]
            if norm:
                layers.append(nn.BatchNorm2d(cout))
            return nn.Sequential(*layers, nn.LeakyReLU(0.2))

        self.model0 = stage(input_nc, ndf, 2, norm=False)
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"model{n}", stage(prev, nf, 2))
        prev, nf = nf, min(nf * 2, 512)
        setattr(self, f"model{n_layers}", stage(prev, nf, 1))
        setattr(self, f"model{n_layers + 1}",
                nn.Sequential(nn.Conv2d(nf, 1, 4, 1, 2)))

    def forward(self, x: torch.Tensor):
        feats: List[torch.Tensor] = []
        for n in range(self.n_layers + 1):
            x = getattr(self, f"model{n}")(x)
            feats.append(x)
        return getattr(self, f"model{self.n_layers + 1}")(x), feats


# ------------------------------------------------------------------ metrics


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian-windowed SSIM of ``(B, C, H, W)`` images (valid windows
    only), the mean of the SSIM map."""
    c = img1.shape[1]
    kern = _gaussian_kernel(kernel_size, sigma).to(img1.device)
    kern = kern.expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x.float(), kern, groups=c)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = ((img1.float() - img2.float()) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / mse)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between two ``(N, D)`` feature sets (the FID
    formula over any embedding), on the host with scipy."""
    import scipy.linalg

    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    covmean = scipy.linalg.sqrtm(cov_a @ cov_b)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov_a.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov_a + offset) @ (cov_b + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov_a + cov_b - 2 * covmean))
