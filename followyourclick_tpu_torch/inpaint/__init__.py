"""Inpaint-Anything compositions: the Stable-Diffusion fill and replace of
a clicked region (``inpaint/fill.py``).

Port of ``followyourclick_tpu/inpaint/``, its SD half; LaMa removal
(``lama.py``, ``remove.py``) is not ported yet.
"""

from followyourclick_tpu_torch.inpaint.fill import (
    fill_anything,
    fill_img_with_sd,
    replace_anything,
    replace_img_with_sd,
)

__all__ = [
    "fill_anything",
    "fill_img_with_sd",
    "replace_anything",
    "replace_img_with_sd",
]
