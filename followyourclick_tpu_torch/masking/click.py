"""Click → mask orchestration.

Port of ``followyourclick_tpu/masking/click.py`` (the reference's
``sam_segment.py`` predict_masks_with_sam and the app's get_masked_img):
one point prompt → three candidate masks, each dilated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from followyourclick_tpu_torch.masking.brush import dilate_mask
from followyourclick_tpu_torch.sam.predictor import SamPredictor


def predict_masks_with_sam(img: np.ndarray,
                           point_coords: Sequence[Sequence[float]],
                           point_labels: Sequence[int],
                           predictor: SamPredictor
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) RGB + clicks → (masks (3, H, W) bool, scores (3,),
    low-res logits)."""
    predictor.set_image(img)
    return predictor.predict(
        point_coords=np.asarray(point_coords, dtype=np.float32),
        point_labels=np.asarray(point_labels, dtype=np.int32),
        multimask_output=True)


def click_to_masks(img: np.ndarray, click_wh: Tuple[int, int],
                   predictor: SamPredictor,
                   dilate_kernel_size: Optional[int] = 15
                   ) -> List[np.ndarray]:
    """One click (w, h) → three uint8 {0, 255} candidate masks, dilated
    unless ``dilate_kernel_size`` is None."""
    masks, _, _ = predict_masks_with_sam(
        img, [[click_wh[0], click_wh[1]]], [1], predictor)
    masks = masks.astype(np.uint8) * 255
    if dilate_kernel_size is not None:
        return [dilate_mask(m, dilate_kernel_size) for m in masks]
    return list(masks)
