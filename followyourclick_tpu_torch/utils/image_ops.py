"""OpenCV's image operations that the click front-end uses, without OpenCV.

The JAX package calls ``cv2.resize`` (bilinear and nearest),
``cv2.dilate`` / ``cv2.erode`` with a square kernel and
``cv2.boundingRect`` on the host. The port keeps no ``cv2`` on its path;
these are numpy / torch copies that give the same pixels:

- :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)``. On uint8 it
  is OpenCV's fixed-point arithmetic bit for bit: float32 source
  coordinates, 11-bit weights each rounded on its own (so a pair need not
  sum to 2048), the horizontal pass into int32, the vertical pass as
  ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2``. The
  column weights are clamped at the borders, the row weights are not (the
  rows are); a size given by factors keeps the factors as the scale, as
  OpenCV does. It takes uint8 only (every caller's images and masks).
- :func:`resize_nearest` is ``cv2.resize(..., INTER_NEAREST)``.
- :func:`dilate` / :func:`erode` are the morphology with a ``k x k`` kernel
  of ones, anchor ``k // 2``: a max (min) pool over a window padded by
  ``(k // 2, k - 1 - k // 2)`` on each axis.
- :func:`bounding_rect` is ``cv2.boundingRect`` of a mask's nonzero pixels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, inv_scale: float, clamp: bool):
    """Source index and the two weights of each destination pixel."""
    scale = 1.0 / inv_scale
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low], s[low] = 0, 0
        f[high], s[high] = 0, src - 1
    return s, np.float32(1) - f, f


def resize_linear(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
                  fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy)`` (bilinear) for a uint8
    ``(H, W)`` / ``(H, W, C)`` array; ``dsize`` is ``(w, h)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, not {img.dtype}")
    H, W = img.shape[:2]
    if dsize is None or dsize == (0, 0):
        w, h = int(np.rint(W * fx)), int(np.rint(H * fy))
        inv_x, inv_y = fx, fy
    else:
        w, h = dsize
        inv_x, inv_y = w / W, h / H
    if (h, w) == (H, W):
        return img.copy()
    x = img[..., None] if img.ndim == 2 else img
    sx, a0, a1 = _taps(W, w, inv_x, clamp=True)
    sx1 = np.minimum(sx + 1, W - 1)
    sy, b0, b1 = _taps(H, h, inv_y, clamp=False)
    rows0, rows1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)
    a0, a1, b0, b1 = (np.rint(c * np.float32(COEF_SCALE)).astype(np.int64)
                      for c in (a0, a1, b0, b1))
    x = x.astype(np.int64)
    r = x[:, sx] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]
    r0, r1 = r[rows0] >> 4, r[rows1] >> 4
    out = (((b0[:, None, None] * r0) >> 16)
           + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def resize_nearest(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=INTER_NEAREST)``; ``dsize``
    is ``(w, h)``: source index ``floor(d * src / dst)``."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    t = t[None, None] if img.ndim == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t.float(), size=(dsize[1], dsize[0]), mode="nearest")
    out = out[0, 0] if img.ndim == 2 else out[0].permute(1, 2, 0)
    return out.numpy().astype(img.dtype)


def _morphology(mask: np.ndarray, k: int, erode: bool) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(mask, dtype=np.uint8)
                         ).float()[None, None]
    lo, hi = k // 2, k - 1 - k // 2
    if erode:  # min pool, the border outside the image ignored
        t = -F.max_pool2d(-F.pad(t, (lo, hi, lo, hi), value=255.0), k, 1)
    else:
        t = F.max_pool2d(F.pad(t, (lo, hi, lo, hi), value=0.0), k, 1)
    return t[0, 0].numpy().astype(np.uint8)


def dilate(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(mask.astype(uint8), np.ones((k, k)))``."""
    return _morphology(mask, k, erode=False)


def erode(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.erode(mask.astype(uint8), np.ones((k, k)))``."""
    return _morphology(mask, k, erode=True)


def bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect(mask)``: (x, y, w, h) of the nonzero pixels,
    ``(0, 0, 0, 0)`` for an empty mask."""
    ys, xs = np.nonzero(mask)
    if not len(ys):
        return 0, 0, 0, 0
    x, y = int(xs.min()), int(ys.min())
    return x, y, int(xs.max()) - x + 1, int(ys.max()) - y + 1
