"""Segment-Anything (SAM): the click → mask front-end.

Port of ``followyourclick_tpu/sam/``: the ViT image encoder with windowed
attention and decomposed relative positions, the random-Fourier prompt
encoder, the two-way-transformer mask decoder, ``SamPredictor`` with the
image embedding cached on the device, the automatic mask generator and the
single-call decoder export. The modules carry the official segment-anything
parameter names, so an official checkpoint loads as it is
(``sam/convert.py``).
"""

from followyourclick_tpu_torch.sam.amg import SamAutomaticMaskGenerator
from followyourclick_tpu_torch.sam.image_encoder import ImageEncoderViT
from followyourclick_tpu_torch.sam.mask_decoder import MaskDecoder
from followyourclick_tpu_torch.sam.predictor import SamPredictor
from followyourclick_tpu_torch.sam.prompt_encoder import PromptEncoder
from followyourclick_tpu_torch.sam.sam import (
    Sam,
    SamConfig,
    build_sam,
    sam_model_registry,
)

__all__ = [
    "ImageEncoderViT",
    "MaskDecoder",
    "PromptEncoder",
    "Sam",
    "SamAutomaticMaskGenerator",
    "SamConfig",
    "SamPredictor",
    "build_sam",
    "sam_model_registry",
]
