"""Camera-motion types: the conditioning values of the UNet's
camera-motion embedding.

Port of ``MOTION_TYPES`` in ``followyourclick_tpu/data/camera_motion.py``
(the reference ``majic_transformes.py`` ``MOTION_TYPES``): a type's index in
this tuple is the ``camera_motion_type`` a request passes. The training-data
augmentation that synthesises these moves from stills is not ported.
"""

from __future__ import annotations

from typing import Tuple

MOTION_TYPES: Tuple[str, ...] = (
    "pan_left", "pan_right", "pan_up", "pan_down",
    "zoom_in", "zoom_out", "rotate_cw", "rotate_ccw",
)

