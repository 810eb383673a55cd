"""Automatic mask generation: prompt the whole image with a point grid,
filter, NMS.

Port of ``followyourclick_tpu/sam/amg.py`` (the reference's
``automatic_mask_generator.py`` defaults: 32x32 points, batches of 64,
predicted IoU >= 0.88, stability >= 0.95 at offset 1, box NMS at 0.7). The
batches go through the predictor's cached embedding; the masks, their
stability scores, boxes and the pairwise box IoU stay on the device, and
only the greedy NMS walk and the kept records come to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from followyourclick_tpu_torch.sam.predictor import SamPredictor
from followyourclick_tpu_torch.sam.sam import MASK_THRESHOLD


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Uniform (n², 2) grid in [0, 1]²."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def calculate_stability_score(logits: torch.Tensor, mask_threshold: float,
                              offset: float) -> torch.Tensor:
    """IoU of the masks thresholded at ``threshold ± offset`` (float64)."""
    high = (logits > (mask_threshold + offset)).sum(dim=(-1, -2))
    low = (logits > (mask_threshold - offset)).sum(dim=(-1, -2))
    return high.double() / low.clamp(min=1).double()


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool → XYXY float32 boxes (max + 1); an empty mask →
    [0, 0, 0, 0]."""
    shape = masks.shape[:-2]
    h, w = masks.shape[-2:]
    masks = masks.reshape(-1, h, w)
    boxes = []
    for axis, size in ((1, w), (2, h)):  # columns (x), then rows (y)
        hit = masks.any(dim=axis)
        idx = torch.arange(size, device=masks.device)
        hi = (hit * (idx + 1)).amax(dim=-1)
        lo = torch.where(hit, idx, size).amin(dim=-1)
        boxes.append((lo, hi))
    (x0, x1), (y0, y1) = boxes
    out = torch.stack([x0, y0, x1, y1], dim=-1).float()
    out = torch.where(masks.flatten(1).any(dim=1)[:, None], out, 0.0)
    return out.reshape(*shape, 4)


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of XYXY boxes (N, 4), float32, as the NMS computes it."""
    x1 = torch.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = torch.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp(min=1e-6)


def box_nms(boxes: torch.Tensor, scores: torch.Tensor,
            iou_thresh: float) -> np.ndarray:
    """Greedy IoU NMS → kept indices (int64), highest score first: the IoU
    matrix on the boxes' device, the walk on the host."""
    iou = box_iou_matrix(boxes).cpu().numpy()
    order = np.argsort(-scores.cpu().numpy(), kind="stable")
    keep: List[int] = []
    while order.size:
        i = int(order[0])
        keep.append(i)
        rest = order[1:]
        order = rest[iou[i, rest] <= np.float32(iou_thresh)]
    return np.asarray(keep, dtype=np.int64)


class SamAutomaticMaskGenerator:
    """Whole-image mask proposals; defaults as the reference's."""

    def __init__(self, predictor: SamPredictor, points_per_side: int = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, min_mask_region_area: int = 0):
        self.predictor = predictor
        self.point_grid = build_point_grid(points_per_side)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area

    @torch.inference_mode()
    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """(H, W, 3) RGB uint8 → mask records sorted by area (largest
        first), each with ``segmentation``, ``area``, ``bbox`` (XYWH),
        ``predicted_iou``, ``stability_score`` and ``point_coords``."""
        self.predictor.set_image(image)
        h, w = image.shape[:2]
        points = self.point_grid * np.array([w, h])
        masks, ious, stabs, pts = [], [], [], []
        for start in range(0, len(points), self.points_per_batch):
            batch = points[start:start + self.points_per_batch]
            logits, iou, _ = self.predictor.predict_torch(
                batch[:, None, :], np.ones((len(batch), 1), np.int32))
            stab = calculate_stability_score(logits, MASK_THRESHOLD,
                                             self.stability_score_offset)
            keep = (iou >= self.pred_iou_thresh) & (
                stab >= self.stability_score_thresh)
            b, k = torch.nonzero(keep, as_tuple=True)
            masks.append(logits[b, k] > MASK_THRESHOLD)
            ious.append(iou[b, k].float())
            stabs.append(stab[b, k])
            pts.append(batch[b.cpu().numpy()])
        masks = torch.cat(masks)
        if not len(masks):
            return []
        ious, stabs = torch.cat(ious).cpu(), torch.cat(stabs).cpu()
        pts = np.concatenate(pts)
        boxes = batched_mask_to_box(masks)
        keep = box_nms(boxes, ious, self.box_nms_thresh)
        areas = masks.flatten(1).sum(dim=1).cpu()
        boxes = boxes.cpu()
        records = []
        for i in keep:
            area = int(areas[i])
            if self.min_mask_region_area and area < self.min_mask_region_area:
                continue
            x0, y0, x1, y1 = (float(v) for v in boxes[i])
            records.append({
                "segmentation": masks[i].cpu().numpy(),
                "area": area,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "predicted_iou": float(ious[i]),
                "stability_score": float(stabs[i]),
                "point_coords": [pts[i].tolist()],
            })
        records.sort(key=lambda r: r["area"], reverse=True)
        return records
