"""Inpaint-Anything compositions and LaMa.

Port of ``followyourclick_tpu/inpaint/``: the FFC-ResNet LaMa generator
(``lama.py``, its checkpoints in ``convert.py``) and the remove-anything
composition (``remove.py``: SAM mask → dilate → LaMa fill); the
Stable-Diffusion fill and replace of a clicked region (``fill.py``); LaMa's
GAN training (``train.py``, ``losses.py``, ``perceptual.py``).
"""

from followyourclick_tpu_torch.inpaint.fill import (
    fill_anything,
    fill_img_with_sd,
    replace_anything,
    replace_img_with_sd,
)
from followyourclick_tpu_torch.inpaint.lama import (
    FFCResNetGenerator,
    LamaConfig,
    LamaInpainter,
)
from followyourclick_tpu_torch.inpaint.remove import remove_anything

__all__ = [
    "FFCResNetGenerator",
    "LamaConfig",
    "LamaInpainter",
    "fill_anything",
    "fill_img_with_sd",
    "remove_anything",
    "replace_anything",
    "replace_img_with_sd",
]
