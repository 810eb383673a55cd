"""Flow training losses.

Port of ``followyourclick_tpu/flow/losses.py`` (mmflow ``SequenceLoss``,
``MultiLevelEPE`` and ``MultiLevelCharbonnierLoss``), NCHW: predictions
``(B, 2, H, W)`` (a sequence stacked in front), ground truth ``(B, 2, H,
W)``, the valid mask ``(B, H, W)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _valid(flow_gt: torch.Tensor, valid: Optional[torch.Tensor],
           max_flow: float) -> torch.Tensor:
    mag = torch.sqrt((flow_gt ** 2).sum(dim=1))
    if valid is None:
        return torch.ones_like(mag)
    return ((valid >= 0.5) & (mag < max_flow)).to(flow_gt.dtype)


def sequence_loss(preds: torch.Tensor, flow_gt: torch.Tensor,
                  gamma: float = 0.8, valid: Optional[torch.Tensor] = None,
                  max_flow: float = 400.0) -> torch.Tensor:
    """RAFT's sequence loss over ``preds (iters, B, 2, H, W)``: iteration i
    weighs ``gamma^(n−i−1)``, each term the mean of the valid-masked L1
    over every element (not normalised by the valid count)."""
    n = preds.shape[0]
    valid = _valid(flow_gt, valid, max_flow)
    i = torch.arange(n, dtype=flow_gt.dtype, device=flow_gt.device)
    weights = gamma ** (n - i - 1.0)
    per_iter = ((preds - flow_gt[None]).abs()
                * valid[None, :, None]).mean(dim=(1, 2, 3, 4))
    return (weights * per_iter).sum()


def _downsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Average ``(B, C, H, W)`` over (H/h)x(W/w) cells (integer ratios)."""
    B, C, H, W = x.shape
    return x.reshape(B, C, h, H // h, w, W // w).mean(dim=(3, 5))


def _multi_level_loss(per_px_fn, preds: Dict[str, torch.Tensor],
                      flow_gt: torch.Tensor,
                      weights: Optional[Dict[str, float]],
                      valid: Optional[torch.Tensor], flow_div: float,
                      max_flow: float, scale_as_level: bool) -> torch.Tensor:
    if weights is None:
        weights = {"level6": 0.32, "level5": 0.08, "level4": 0.02,
                   "level3": 0.01, "level2": 0.005}
    B, _, H, W = flow_gt.shape
    valid_full = _valid(flow_gt, valid, max_flow)
    target = flow_gt / flow_div
    total = 0.0
    for name, weight in weights.items():
        pred = preds[name]
        h, w = pred.shape[2:]
        if scale_as_level:
            scale = torch.tensor([w / W, h / H], dtype=flow_gt.dtype,
                                 device=flow_gt.device)[:, None, None]
            gt = _downsample_to(target * scale, h, w)
        else:
            gt = _downsample_to(target, h, w)
        v = _downsample_to(valid_full[:, None], h, w)[:, 0]
        per_px = per_px_fn(pred, gt) * (v >= 0.5).to(flow_gt.dtype)
        total = total + weight * per_px.sum() / B
    return total


def multi_level_epe_loss(preds: Dict[str, torch.Tensor],
                         flow_gt: torch.Tensor,
                         weights: Optional[Dict[str, float]] = None,
                         valid: Optional[torch.Tensor] = None,
                         flow_div: float = 20.0,
                         max_flow: float = float("inf"), p: float = 2.0,
                         q: Optional[float] = None, eps: float = 0.0,
                         scale_as_level: bool = False) -> torch.Tensor:
    """Multi-level EPE: ``‖pred − gt/flow_div‖₂`` per pixel (or ``(Σ|diff|^p
    + eps)^q``), summed a level, weighted, divided by the batch."""

    def per_px(pred, gt):
        diff = pred - gt
        if q is None:
            return torch.sqrt((diff ** 2).sum(dim=1) + eps)
        return ((diff.abs() ** p).sum(dim=1) + eps) ** q

    return _multi_level_loss(per_px, preds, flow_gt, weights, valid,
                             flow_div, max_flow, scale_as_level)


def multi_level_charbonnier_loss(preds: Dict[str, torch.Tensor],
                                 flow_gt: torch.Tensor,
                                 weights: Optional[Dict[str, float]] = None,
                                 valid: Optional[torch.Tensor] = None,
                                 flow_div: float = 20.0,
                                 max_flow: float = float("inf"),
                                 q: float = 0.2, eps: float = 0.01,
                                 scale_as_level: bool = False
                                 ) -> torch.Tensor:
    """Charbonnier: ``(‖diff‖² + eps)^q`` per pixel."""

    def per_px(pred, gt):
        return (((pred - gt) ** 2).sum(dim=1) + eps) ** q

    return _multi_level_loss(per_px, preds, flow_gt, weights, valid,
                             flow_div, max_flow, scale_as_level)
