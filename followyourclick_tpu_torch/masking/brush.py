"""Mask dilation / crop / paste utilities.

Port of ``followyourclick_tpu/masking/brush.py`` (the reference's
``brush_utils``): dilate / erode, the 512 crop centred on the mask's
bounding box with the proportional-resize and pad-to-square fallbacks and
its paste-back under the mask, ``resize_and_pad`` / ``recover_size`` and
``paste_object``. OpenCV's calls are ``utils/image_ops``, which give the
same pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from followyourclick_tpu_torch.utils.image_ops import (
    bounding_rect,
    dilate,
    erode,
    resize_linear,
)


def dilate_mask(mask: np.ndarray, dilate_factor: int = 15) -> np.ndarray:
    """Square-kernel dilation of ``mask`` as uint8."""
    return dilate(mask.astype(np.uint8), dilate_factor)


def erode_mask(mask: np.ndarray, dilate_factor: int = 15) -> np.ndarray:
    return erode(mask.astype(np.uint8), dilate_factor)


def _resize_min_side(image, mask, crop_size):
    height, width = image.shape[:2]
    aspect = float(width) / float(height)
    if min(height, width) < crop_size:
        if height < width:
            nh = crop_size
            nw = int(nh * aspect)
        else:
            nw = crop_size
            nh = int(nw / aspect)
        image = resize_linear(image, (nw, nh))
        mask = resize_linear(mask, (nw, nh))
    return image, mask


def _pad_square_and_fit(image, mask, crop_size):
    """Pad to square, then scale so the mask's box fits ``crop_size``.
    Returns (image, mask, resize_factor, padding, padding_side)."""
    height, width = image.shape[:2]
    if height < width:
        padding = width - height
        pads = (padding // 2, padding - padding // 2)
        image = np.pad(image, (pads, (0, 0), (0, 0)), "constant")
        mask = np.pad(mask, (pads, (0, 0)), "constant")
        side = "h"
    else:
        padding = height - width
        pads = (padding // 2, padding - padding // 2)
        image = np.pad(image, ((0, 0), pads, (0, 0)), "constant")
        mask = np.pad(mask, ((0, 0), pads), "constant")
        side = "w"
    x, y, w, h = bounding_rect(mask)
    factor = crop_size / max(w, h)
    image = resize_linear(image, (0, 0), fx=factor, fy=factor)
    mask = resize_linear(mask, (0, 0), fx=factor, fy=factor)
    return image, mask, factor, padding, side


def _crop_origin(mask, image, crop_size):
    x, y, w, h = bounding_rect(mask)
    height, width = image.shape[:2]
    return (min(max(x + w // 2 - crop_size // 2, 0), width - crop_size),
            min(max(y + h // 2 - crop_size // 2, 0), height - crop_size))


def crop_for_filling_pre(image: np.ndarray, mask: np.ndarray,
                         crop_size: int = 512
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """A ``crop_size``² window centred on the mask's box, after upscaling
    or padding when needed."""
    image, mask = _resize_min_side(image, mask, crop_size)
    _, _, w, h = bounding_rect(mask)
    if w > crop_size or h > crop_size:
        image, mask, _, _, _ = _pad_square_and_fit(image, mask, crop_size)
    cx, cy = _crop_origin(mask, image, crop_size)
    return (image[cy:cy + crop_size, cx:cx + crop_size],
            mask[cy:cy + crop_size, cx:cx + crop_size])


def crop_for_filling_post(image: np.ndarray, mask: np.ndarray,
                          filled_image: np.ndarray,
                          crop_size: int = 512) -> np.ndarray:
    """Paste a filled crop back into the original image, only under the
    mask (on copies: the caller's arrays are not written)."""
    image_copy = image.copy()
    mask_copy = mask.copy()
    height_ori, width_ori = image.shape[:2]
    image, mask = _resize_min_side(image.copy(), mask.copy(), crop_size)
    _, _, w, h = bounding_rect(mask)
    flag_padding = w > crop_size or h > crop_size
    if flag_padding:
        image, mask, resize_factor, padding, padding_side = \
            _pad_square_and_fit(image, mask, crop_size)
    cx, cy = _crop_origin(mask, image, crop_size)
    image[cy:cy + crop_size, cx:cx + crop_size] = filled_image
    if flag_padding:
        image = resize_linear(image, (0, 0), fx=1 / resize_factor,
                              fy=1 / resize_factor)
        if padding_side == "h":
            image = image[padding // 2:padding // 2 + height_ori, :]
        else:
            image = image[:, padding // 2:padding // 2 + width_ori]
    image = resize_linear(image, (width_ori, height_ori))
    image_copy[mask_copy == 255] = image[mask_copy == 255]
    return image_copy


def resize_and_pad(image: np.ndarray, mask: np.ndarray,
                   target_size: int = 512
                   ) -> Tuple[np.ndarray, np.ndarray,
                              Tuple[int, int, int, int]]:
    """Long-side resize and centre pad to ``target_size``²."""
    height, width = image.shape[:2]
    scale = target_size / max(height, width)
    nh, nw = int(height * scale), int(width * scale)
    image_r = resize_linear(image, (nw, nh))
    mask_r = resize_linear(mask, (nw, nh))
    ph, pw = target_size - nh, target_size - nw
    top, left = ph // 2, pw // 2
    image_p = np.pad(image_r, ((top, ph - top), (left, pw - left), (0, 0)),
                     mode="constant")
    mask_p = np.pad(mask_r, ((top, ph - top), (left, pw - left)),
                    mode="constant")
    return image_p, mask_p, (top, ph - top, left, pw - left)


def recover_size(image_padded: np.ndarray, mask_padded: np.ndarray,
                 orig_size: Tuple[int, int],
                 padding_factors: Tuple[int, int, int, int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The inverse of :func:`resize_and_pad`."""
    h, w = image_padded.shape[:2]
    top, bottom, left, right = padding_factors
    image = image_padded[top:h - bottom, left:w - right]
    mask = mask_padded[top:h - bottom, left:w - right]
    image = resize_linear(image, tuple(orig_size[::-1]))
    mask = resize_linear(mask, tuple(orig_size[::-1]))
    return image, mask


def paste_object(source: np.ndarray, source_mask: np.ndarray,
                 target: np.ndarray, target_coords: Tuple[int, int],
                 resize_scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Cut the masked object out of ``source`` and paste it into ``target``
    centred at ``target_coords``. Returns (image, mask)."""
    assert target_coords[0] < target.shape[1]
    assert target_coords[1] < target.shape[0]
    x, y, w, h = bounding_rect(source_mask)
    obj = source[y:y + h, x:x + w]
    obj_msk = source_mask[y:y + h, x:x + w]
    if resize_scale != 1:
        obj = resize_linear(obj, (0, 0), fx=resize_scale, fy=resize_scale)
        obj_msk = resize_linear(obj_msk, (0, 0), fx=resize_scale,
                                fy=resize_scale)
        _, _, w, h = bounding_rect(obj_msk)

    # clip the object when the paste centre is near the target border
    xt = max(0, target_coords[0] - w // 2)
    yt = max(0, target_coords[1] - h // 2)
    if target_coords[0] - w // 2 < 0:
        obj = obj[:, w // 2 - target_coords[0]:]
        obj_msk = obj_msk[:, w // 2 - target_coords[0]:]
    if target_coords[1] - h // 2 < 0:
        obj = obj[h // 2 - target_coords[1]:, :]
        obj_msk = obj_msk[h // 2 - target_coords[1]:, :]
    hh = min(obj.shape[0], target.shape[0] - yt)
    ww = min(obj.shape[1], target.shape[1] - xt)
    obj = obj[:hh, :ww]
    obj_msk = obj_msk[:hh, :ww]

    out = target.copy()
    region = out[yt:yt + hh, xt:xt + ww]
    sel = obj_msk > 0
    region[sel] = obj[sel]
    out[yt:yt + hh, xt:xt + ww] = region
    out_mask = np.zeros(target.shape[:2], dtype=np.uint8)
    out_mask[yt:yt + hh, xt:xt + ww][sel] = 255
    return out, out_mask
