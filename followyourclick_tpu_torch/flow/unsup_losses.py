"""Occlusion BCE and the unsupervised photometric / smoothness flow losses.

Port of ``followyourclick_tpu/flow/unsup_losses.py`` (mmflow
``multilevel_bce.py``, ``census_loss.py``, ``smooth_loss.py``), NCHW:
occlusion logits and targets ``(B, 1, H, W)``, images ``(B, 3, H, W)`` in
[0, 1], flows ``(B, 2, H, W)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         balance: bool = False,
                         reduction: str = "sum") -> torch.Tensor:
    """Sigmoid BCE of ``pred`` logits against ``target``; ``balance``
    weighs the positives by ``0.5·HW / (Σ target + Σ p)`` and the
    negatives alike (IRR-PWC); ``"sum"`` divides the sum by the batch,
    ``"none"`` gives ``(B, H, W)``."""
    assert pred.shape == target.shape
    b = pred.shape[0]
    h, w = pred.shape[2:]
    p = torch.sigmoid(pred)
    if balance:
        tp_w = 0.5 * h * w / (target.sum(dim=(1, 2, 3))
                              + p.sum(dim=(1, 2, 3)) + 1e-8)
        fn_w = 0.5 * h * w / ((1 - target).sum(dim=(1, 2, 3))
                              + (1 - p).sum(dim=(1, 2, 3)) + 1e-8)
    else:
        tp_w = pred.new_ones(b)
        fn_w = pred.new_ones(b)
    tp = -target * torch.log(p + 1e-8) * tp_w[:, None, None, None]
    fn = -(1 - target) * torch.log(1 - p + 1e-8) * fn_w[:, None, None, None]
    bce = tp + fn
    if reduction == "none":
        return bce[:, 0]
    if reduction == "mean":
        return bce.mean()
    return bce.sum() / b


def multi_level_bce(preds: Dict[str, Union[torch.Tensor,
                                           Sequence[torch.Tensor]]],
                    target: torch.Tensor,
                    weights: Optional[Dict[str, float]] = None,
                    balance: bool = False) -> torch.Tensor:
    """mmflow ``MultiLevelBCE``: the target averaged down to each level; a
    level holding a list (IRR-PWC's [raw, refined]) averages its terms."""
    if weights is None:
        weights = {"level6": 0.32, "level5": 0.08, "level4": 0.02,
                   "level3": 0.01, "level2": 0.005}
    B, _, H, W = target.shape
    total = 0.0
    for name, weight in weights.items():
        level = preds[name]
        if not isinstance(level, (list, tuple)):
            level = [level]
        for pred in level:
            h, w = pred.shape[2:]
            gt = target.reshape(B, 1, h, H // h, w, W // w).mean(dim=(3, 5))
            total = total + weight * binary_cross_entropy(
                pred, gt, balance=balance) / len(level)
    return total


def census_loss(image1: torch.Tensor, image2: torch.Tensor,
                patch_size: int = 3) -> torch.Tensor:
    """Soft census loss: the soft census transform of the grayscale ×
    255, the soft Hamming distance, averaged inside a border of
    ``patch_size // 2``."""
    p = patch_size // 2

    def census(img):
        inten = (img[:, 0:1] * 0.2989 + img[:, 1:2] * 0.5870
                 + img[:, 2:3] * 0.1140) * 255.0
        H, W = inten.shape[2:]
        padded = F.pad(inten, (p, p, p, p))
        t = torch.cat([padded[:, :, dy:dy + H, dx:dx + W]
                       for dy in range(patch_size)
                       for dx in range(patch_size)], dim=1) - inten
        return t / torch.sqrt(0.81 + t * t)

    dist = (census(image1) - census(image2)) ** 2
    dist = (dist / (0.1 + dist)).mean(dim=1, keepdim=True)
    B, _, H, W = image1.shape
    mask = torch.zeros(B, 1, H, W, dtype=dist.dtype, device=dist.device)
    mask[:, :, p:H - p, p:W - p] = 1.0
    return (dist * mask).sum() / mask.sum()


def _gradient(x: torch.Tensor, stride: int = 1):
    return (x[:, :, :, stride:] - x[:, :, :, :-stride],
            x[:, :, stride:] - x[:, :, :-stride])


def _edge_weights(image: torch.Tensor, alpha: float, weighting: str,
                  stride: int):
    fn = torch.abs if weighting == "exponential" else torch.square
    img_dx, img_dy = _gradient(image, stride)
    return (torch.exp(-fn(img_dx * alpha).mean(dim=1, keepdim=True)),
            torch.exp(-fn(img_dy * alpha).mean(dim=1, keepdim=True)))


def smooth_1st_loss(flow: torch.Tensor, image: torch.Tensor,
                    alpha: float = 0.0,
                    smooth_edge_weighting: str = "exponential"
                    ) -> torch.Tensor:
    """Edge-weighted first-order smoothness (mmflow
    ``smooth_loss.py:27-71``)."""
    wx, wy = _edge_weights(image, alpha, smooth_edge_weighting, 1)
    dx, dy = _gradient(flow)
    return (wx * dx.abs() / 2.0).mean() + (wy * dy.abs() / 2.0).mean()


def smooth_2nd_loss(flow: torch.Tensor, image: torch.Tensor,
                    alpha: float = 0.0,
                    smooth_edge_weighting: str = "exponential"
                    ) -> torch.Tensor:
    """Edge-weighted second-order smoothness (mmflow
    ``smooth_loss.py:73-120``)."""
    wx, wy = _edge_weights(image, alpha, smooth_edge_weighting, 2)
    fdx, fdy = _gradient(flow)
    fdx2 = fdx[:, :, :, 1:] - fdx[:, :, :, :-1]
    fdy2 = fdy[:, :, 1:] - fdy[:, :, :-1]
    return (wx * fdx2.abs() / 2.0).mean() + (wy * fdy2.abs() / 2.0).mean()
