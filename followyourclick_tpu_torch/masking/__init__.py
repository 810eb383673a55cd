"""Host-side mask tools: the click → mask orchestration and the brush
utilities (dilate, crop, paste).

Port of ``followyourclick_tpu/masking/``, with no OpenCV: the resizes and
the morphology are ``utils/image_ops``.
"""

from followyourclick_tpu_torch.masking.brush import (
    crop_for_filling_post,
    crop_for_filling_pre,
    dilate_mask,
    erode_mask,
    paste_object,
    recover_size,
    resize_and_pad,
)
from followyourclick_tpu_torch.masking.click import predict_masks_with_sam

__all__ = [
    "crop_for_filling_post",
    "crop_for_filling_pre",
    "dilate_mask",
    "erode_mask",
    "paste_object",
    "predict_masks_with_sam",
    "recover_size",
    "resize_and_pad",
]
