"""Remove-anything composition: click → SAM masks → dilate → LaMa fill.

Port of ``followyourclick_tpu/inpaint/remove.py`` (the reference's
``remove_anything.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from followyourclick_tpu_torch.inpaint.lama import LamaInpainter
from followyourclick_tpu_torch.masking.brush import dilate_mask
from followyourclick_tpu_torch.masking.click import predict_masks_with_sam
from followyourclick_tpu_torch.sam.predictor import SamPredictor


def remove_anything(img: np.ndarray, point_wh: Tuple[int, int],
                    predictor: SamPredictor, inpainter: LamaInpainter,
                    dilate_kernel_size: Optional[int] = 15) -> List[dict]:
    """(H, W, 3) RGB uint8 + click → one record per SAM candidate mask:
    ``{"mask": uint8, "score": float, "inpainted": uint8 image with the
    object removed}``."""
    masks, scores, _ = predict_masks_with_sam(
        img, [[point_wh[0], point_wh[1]]], [1], predictor)
    masks = masks.astype(np.uint8) * 255
    results = []
    for i in range(masks.shape[0]):
        mask = masks[i]
        if dilate_kernel_size is not None:
            mask = dilate_mask(mask, dilate_kernel_size)
        results.append({"mask": mask, "score": float(scores[i]),
                        "inpainted": inpainter(img, mask)})
    return results
