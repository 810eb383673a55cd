"""Camera-motion augmentation: labelled camera moves synthesised from
stills, and the motion types the UNet's camera-motion embedding takes.

Port of ``followyourclick_tpu/data/camera_motion.py`` (the reference
``majic_transformes.py``: ``MOTION_TYPES`` and a crop window moved over a
still). A type's index in ``MOTION_TYPES`` is the ``camera_motion_type``
a request passes.

No cv2: :func:`rotation_matrix_2d` is ``cv2.getRotationMatrix2D`` written
out in float64, and :func:`warp_affine` is ``cv2.warpAffine(...,
INTER_LINEAR)`` with its constant-0 border as torch ops on the image's
device. OpenCV's warp (5.0) samples in float32: each source coordinate a
row's float32 base (a product and a sum, each rounded) plus the column's
product, rounded once (a fused multiply-add); bilinear taps outside the
image read 0, the value is rounded half to even. The port does the
same, the fused step made explicit in float64, so the card and the CPU
give the same bytes and a rare pixel of OpenCV's differs by 1.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

MOTION_TYPES: Tuple[str, ...] = (
    "pan_left", "pan_right", "pan_up", "pan_down",
    "zoom_in", "zoom_out", "rotate_cw", "rotate_ccw",
)


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: ``(2, 3)`` float64, ``angle`` in
    degrees, counter-clockwise; the centre is a float32 point, as
    OpenCV's ``Point2f``."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverted(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(image: torch.Tensor, matrix: np.ndarray,
                size: Tuple[int, int]) -> torch.Tensor:
    """``cv2.warpAffine(image, matrix, size, flags=INTER_LINEAR)`` of an
    ``(H, W, C)`` uint8 tensor: ``(h, w, C)`` uint8 for ``size = (w,
    h)``, on the image's device."""
    H, W, C = image.shape
    ow, oh = size
    dev = image.device
    a = torch.tensor(_inverted(matrix), dtype=torch.float32, device=dev)
    x = torch.arange(ow, dtype=torch.float64, device=dev)[None]
    y = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]

    def coord(r):
        row = a[r, 1] * y + a[r, 2]         # float32, rounded twice
        return (a[r, 0].double() * x + row.double()).float()  # once

    sxf, syf = coord(0), coord(1)
    sx, sy = torch.floor(sxf), torch.floor(syf)
    ax, ay = (sxf - sx)[..., None], (syf - sy)[..., None]
    sx, sy = sx.long(), sy.long()
    flat = image.reshape(H * W, C).float()

    def tap(dx, dy):
        xi, yi = sx + dx, sy + dy
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[idx] * inside[..., None]

    p00, p10, p01, p11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    v0 = p00 + ax * (p10 - p00)
    v1 = p01 + ax * (p11 - p01)
    out = v0 + ay * (v1 - v0)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _crop(image: torch.Tensor, cx: float, cy: float, size: float,
          angle: float, out_hw: Tuple[int, int]) -> torch.Tensor:
    """The rotated square crop of side ``size`` centred at (cx, cy),
    scaled to ``out_hw``."""
    oh, ow = out_hw
    m = rotation_matrix_2d((cx, cy), angle, out_hw[1] / size)
    m[0, 2] += ow / 2 - cx
    m[1, 2] += oh / 2 - cy
    return warp_affine(image, m, (ow, oh))


class CameraMotionAugmentation:
    """``image (H, W, 3)`` uint8 → ``(frames (F, out, out, 3) uint8,
    motion type index)``; the crops are warped on ``device`` and handed
    back as numpy. A type not given is drawn from ``seed``'s
    ``np.random.RandomState``, as the JAX class draws it."""

    def __init__(self, num_frames: int = 16, out_size: int = 512,
                 pan_fraction: float = 0.2, zoom_fraction: float = 0.25,
                 max_rotation_deg: float = 12.0, seed: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.num_frames = num_frames
        self.out_size = out_size
        self.pan_fraction = pan_fraction
        self.zoom_fraction = zoom_fraction
        self.max_rotation_deg = max_rotation_deg
        self.rng = np.random.RandomState(seed)
        self.device = torch.device(device)

    def __call__(self, image: np.ndarray,
                 motion_type: Optional[str] = None) -> Tuple[np.ndarray, int]:
        if motion_type is None:
            motion_type = MOTION_TYPES[self.rng.randint(len(MOTION_TYPES))]
        idx = MOTION_TYPES.index(motion_type)
        h, w = image.shape[:2]
        f = self.num_frames
        base = min(h, w) * (1.0 - self.pan_fraction)
        cx0, cy0 = w / 2, h / 2
        t = np.linspace(0.0, 1.0, f)
        cxs, cys = np.full(f, cx0), np.full(f, cy0)
        sizes, angles = np.full(f, base), np.zeros(f)
        span_x, span_y = (w - base) / 2, (h - base) / 2
        if motion_type == "pan_left":
            cxs = cx0 + span_x * (1 - 2 * t)
        elif motion_type == "pan_right":
            cxs = cx0 - span_x * (1 - 2 * t)
        elif motion_type == "pan_up":
            cys = cy0 + span_y * (1 - 2 * t)
        elif motion_type == "pan_down":
            cys = cy0 - span_y * (1 - 2 * t)
        elif motion_type == "zoom_in":
            sizes = base * (1.0 - self.zoom_fraction * t)
        elif motion_type == "zoom_out":
            sizes = base * (1.0 - self.zoom_fraction * (1 - t))
        elif motion_type == "rotate_cw":
            angles = -self.max_rotation_deg * t
        elif motion_type == "rotate_ccw":
            angles = self.max_rotation_deg * t
        else:
            raise ValueError(motion_type)
        src = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        out = (self.out_size, self.out_size)
        frames = torch.stack([_crop(src, cxs[i], cys[i], sizes[i], angles[i],
                                    out) for i in range(f)])
        return frames.cpu().numpy(), idx


def synthesize_camera_clip(image: np.ndarray, motion_type: str,
                           num_frames: int = 16, out_size: int = 512,
                           device: Union[str, torch.device] = "cuda"
                           ) -> np.ndarray:
    return CameraMotionAugmentation(num_frames, out_size, device=device)(
        image, motion_type)[0]
