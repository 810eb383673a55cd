"""Video and image I/O: the GIF grid writer and the host-side image and mask
preprocessing of the CLI.

Port of ``followyourclick_tpu/utils/video_io.py`` (the reference's
``save_videos_grid``, ``scripts/inference.py:314-365``). PIL and imageio are
imported where they are used, as in the JAX package. GIFs are written by
PIL alone: the JAX package's ``imageio.mimsave`` hands the same frames and
options to PIL's GIF writer, so the files are the same byte for byte, and
imageio is needed only for an mp4. The click-mask downsample, which the
JAX package does with ``cv2.resize(INTER_LINEAR)``, is
``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``
here (the same half-pixel centres and no antialiasing), so no ``cv2`` is
needed.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def videos_grid_frames(videos: np.ndarray, n_rows: int = 4,
                       rescale: bool = False) -> list[np.ndarray]:
    """(B, F, H, W, 3) float in [0, 1] (in [-1, 1] with ``rescale``) → F
    uint8 grid frames: clip ``b`` at row ``b % n_rows``, column
    ``b // n_rows``."""
    b, f, h, w, c = videos.shape
    n_rows = min(n_rows, b)
    n_cols = (b + n_rows - 1) // n_rows
    frames = []
    for fi in range(f):
        grid = np.zeros((n_rows * h, n_cols * w, c), dtype=np.float32)
        for bi in range(b):
            r, col = bi % n_rows, bi // n_rows
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = videos[bi, fi]
        if rescale:
            grid = (grid + 1.0) / 2.0
        frames.append((np.clip(grid, 0, 1) * 255).astype(np.uint8))
    return frames


def save_videos_grid(videos: np.ndarray, path: str, fps: int = 8,
                     n_rows: int = 4, rescale: bool = False) -> None:
    """(B, F, H, W, 3) → an endlessly looping GIF of grid frames."""
    from PIL import Image

    images = [Image.fromarray(f)
              for f in videos_grid_frames(videos, n_rows, rescale)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    images[0].save(path, save_all=True, append_images=images[1:],
                   duration=1000.0 / fps, loop=0)


def save_video_mp4(video: np.ndarray, path: str, fps: int = 8) -> None:
    """(F, H, W, 3) float in [0, 1] → mp4 (where imageio has an ffmpeg
    backend)."""
    import imageio

    frames = (np.clip(video, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.mimsave(path, list(frames), fps=fps)


def load_image_and_mask(image_path: str, mask_path: str | None,
                        height: int, width: int,
                        crop_method: str = "crop"):
    """The first image and its click mask at (H, W): image float32
    (H, W, 3) in [-1, 1], mask float32 (H, W, 1) in {0, 1} or None.
    ``crop_method``: "crop" = aspect-preserving resize + centre crop;
    "resize_and_crop" = squash to a max(W, H) square, then centre crop."""
    from PIL import Image

    img = Image.open(image_path).convert("RGB")
    img = preprocess_pil(img, height, width, crop_method)
    arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
    mask_arr = None
    if mask_path:
        m = Image.open(mask_path).convert("L")
        m = preprocess_pil(m, height, width, crop_method)
        mask_arr = np.asarray(m, dtype=np.float32) / 255.0
        mask_arr = (mask_arr > 0.5).astype(np.float32)[..., None]
    return arr, mask_arr


def preprocess_pil(img, height: int, width: int, crop_method: str = "crop"):
    """One PIL image through the reference's crop pipeline."""
    if crop_method == "resize_and_crop":
        target = max(width, height)
        img = img.resize((target, target))
        left = round(max(0, (target - width) / 2))
        top = round(max(0, (target - height) / 2))
        right = round(min(target, (target + width) / 2))
        bottom = round(min(target, (target + height) / 2))
        return img.crop((left, top, right, bottom))
    if crop_method == "crop":
        return _resize_center_crop(img, height, width)
    raise ValueError(crop_method)


# CLIP image normalisation (transformers CLIPImageProcessor)
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess_image(image, image_size: int = 224) -> np.ndarray:
    """A PIL image or a float / uint8 array → CLIP-vision pixel values
    (1, S, S, 3) (a float array in [-1, 1] or [0, 1])."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        arr = image
        if arr.dtype != np.uint8:
            if float(arr.min()) < -0.01:
                arr = (arr + 1.0) / 2.0
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        image = Image.fromarray(arr)
    img = _resize_center_crop(image.convert("RGB"), image_size, image_size)
    x = np.asarray(img, dtype=np.float32) / 255.0
    x = (x - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
    return x[None]


def _resize_center_crop(img, height: int, width: int):
    from PIL import Image

    w0, h0 = img.size
    scale = max(width / w0, height / h0)
    nw, nh = int(round(w0 * scale)), int(round(h0 * scale))
    img = img.resize((nw, nh), Image.LANCZOS)
    left = (nw - width) // 2
    top = (nh - height) // 2
    return img.crop((left, top, left + width, top + height))


def downsample_mask_to_latent(mask: np.ndarray, latent_h: int,
                              latent_w: int) -> np.ndarray:
    """(H, W, 1) → (h, w, 1): bilinear at half-pixel centres, no
    antialiasing (``cv2.INTER_LINEAR``), clamped to [0, 1]."""
    m = torch.from_numpy(np.ascontiguousarray(mask[..., 0],
                                              dtype=np.float32))
    m = F.interpolate(m[None, None], size=(latent_h, latent_w),
                      mode="bilinear", align_corners=False,
                      antialias=False)[0, 0]
    return np.clip(m.numpy(), 0.0, 1.0)[..., None].astype(np.float32)


def slerp(t: float, v0: np.ndarray, v1: np.ndarray,
          dot_threshold: float = 0.9995) -> np.ndarray:
    """Spherical interpolation; linear where the two are nearly parallel."""
    dot = np.sum(v0 * v1 / (np.linalg.norm(v0) * np.linalg.norm(v1)))
    if np.abs(dot) > dot_threshold:
        return (1 - t) * v0 + t * v1
    theta = np.arccos(dot)
    return (np.sin((1 - t) * theta) * v0 + np.sin(t * theta) * v1) \
        / np.sin(theta)
