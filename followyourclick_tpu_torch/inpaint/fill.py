"""Fill-anything / replace-anything compositions.

Port of ``followyourclick_tpu/inpaint/fill.py`` (the reference's
``fill_anything.py``: SAM click mask → dilate → 512 crop around the
mask → SD-inpaint the crop with the text prompt → paste back under the
mask; and ``replace_anything.py``: keep the object, repaint the inverted
mask, the background, through ``resize_and_pad`` / ``recover_size``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from followyourclick_tpu_torch.masking.brush import (
    crop_for_filling_post,
    crop_for_filling_pre,
    dilate_mask,
    recover_size,
    resize_and_pad,
)
from followyourclick_tpu_torch.masking.click import predict_masks_with_sam
from followyourclick_tpu_torch.pipelines.inpaint import InpaintPipeline
from followyourclick_tpu_torch.sam.predictor import SamPredictor


def fill_img_with_sd(img: np.ndarray, mask: np.ndarray, prompt: str,
                     pipeline: InpaintPipeline, seed: int = 0,
                     steps: int = 25) -> np.ndarray:
    """Crop → inpaint → paste back."""
    crop_img, crop_mask = crop_for_filling_pre(img, mask)
    filled = pipeline(crop_img, crop_mask, prompt, steps=steps, seed=seed)
    return crop_for_filling_post(img, mask, filled)


def replace_img_with_sd(img: np.ndarray, mask: np.ndarray, prompt: str,
                        pipeline: InpaintPipeline, seed: int = 0,
                        steps: int = 25, target_size: int = 512
                        ) -> np.ndarray:
    """Repaint everything except the mask (background replacement)."""
    padded_img, padded_mask, pads = resize_and_pad(img, mask, target_size)
    inverted = 255 - (padded_mask > 0).astype(np.uint8) * 255
    out = pipeline(padded_img, inverted, prompt, steps=steps, seed=seed)
    recovered, _ = recover_size(out, padded_mask, img.shape[:2], pads)
    return recovered


def _click_masks(img, point_wh, predictor):
    masks, scores, _ = predict_masks_with_sam(
        img, [[point_wh[0], point_wh[1]]], [1], predictor)
    return masks.astype(np.uint8) * 255, scores


def fill_anything(img: np.ndarray, point_wh: Tuple[int, int], prompt: str,
                  predictor: SamPredictor, pipeline: InpaintPipeline,
                  dilate_kernel_size: Optional[int] = 15, seed: int = 0,
                  steps: int = 25) -> List[dict]:
    """Click → SAM masks → dilate → fill each candidate."""
    masks, scores = _click_masks(img, point_wh, predictor)
    out = []
    for mask, score in zip(masks, scores):
        if dilate_kernel_size is not None:
            mask = dilate_mask(mask, dilate_kernel_size)
        out.append({"mask": mask, "score": float(score),
                    "filled": fill_img_with_sd(img, mask, prompt, pipeline,
                                               seed=seed, steps=steps)})
    return out


def replace_anything(img: np.ndarray, point_wh: Tuple[int, int], prompt: str,
                     predictor: SamPredictor, pipeline: InpaintPipeline,
                     seed: int = 0, steps: int = 25, target_size: int = 512
                     ) -> List[dict]:
    """Click → SAM masks → replace the background of each candidate."""
    masks, scores = _click_masks(img, point_wh, predictor)
    return [{"mask": mask, "score": float(score),
             "replaced": replace_img_with_sd(img, mask, prompt, pipeline,
                                             seed=seed, steps=steps,
                                             target_size=target_size)}
            for mask, score in zip(masks, scores)]
