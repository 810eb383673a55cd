"""WebVid-style video dataset — host-side loader feeding device batches.

Port of ``followyourclick_tpu/data/dataset.py`` (numpy on the host; ``cv2``
imported where it is used, as there). Behavior spec: reference ``animatediff/data/dataset.py`` — CSV-driven loader
(:86-234), **dynamic fps** (random stride 2–24 returned as the ``fps``
conditioning value, :140-143), stride-adaptive frame list (:156-166),
motion-area mask via frame differencing + contour bounding boxes
(``get_moved_area_mask`` :23-69), infinite retry-on-error resampling
(:231-234). The reference decodes with decord; here OpenCV's VideoCapture
(cv2 ships in-image; decord does not) — the output contract is identical.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Optional

import numpy as np


def get_moved_area_mask(frames: np.ndarray, move_th: int = 5,
                        th: int = -1) -> np.ndarray:
    """Union of bounding boxes of moving regions (uint8 {0,255} HxW).

    frames: (F, H, W, 3) uint8. Reference dataset.py:23-69: accumulate
    thresholded |frame_i - frame_0| masks, then keep contour bounding boxes
    larger than 0.5% of the image.
    """
    import cv2

    ref_gray = cv2.cvtColor(frames[0], cv2.COLOR_BGR2GRAY)
    total_mask = np.zeros_like(ref_gray)
    for i in range(1, len(frames)):
        gray = cv2.cvtColor(frames[i], cv2.COLOR_BGR2GRAY)
        diff = cv2.absdiff(ref_gray, gray)
        _, mask = cv2.threshold(diff, move_th, 255, cv2.THRESH_BINARY)
        total_mask = cv2.bitwise_or(total_mask, mask)

    contours, _ = cv2.findContours(total_mask, cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_SIMPLE)
    mask = np.zeros_like(ref_gray)
    if th < 0:
        h, w = mask.shape
        th = int(h * w * 0.005)
    for cnt in contours:
        x, y, w, h = cv2.boundingRect(cnt)
        if w * h < th:
            continue
        mask[y:y + h, x:x + w] = 255
    return mask


def _read_frames_cv2(path: str, indices: List[int]) -> np.ndarray:
    """Decode the requested frame indices (sorted) from a video file."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    want = set(indices)
    frames = {}
    last = max(indices)
    i = 0
    while i <= last:
        ok, frame = cap.read()
        if not ok:
            break
        if i in want:
            frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        i += 1
    cap.release()
    if len(frames) != len(want):
        raise IOError(f"short read from {path}: got {len(frames)}/{len(want)}")
    return np.stack([frames[i] for i in indices])


def _video_length_cv2(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


class WebVidDataset:
    """CSV rows with ``videoid`` and ``name`` columns; videos at
    ``{video_folder}/{videoid}.mp4``. Yields dicts with:

    - ``pixel_values``: (F, H, W, 3) float32 in [-1, 1]
    - ``text``: caption
    - ``fps``: the sampling stride (the dynamic-fps conditioning value)
    - ``mask``: (H, W, 1) float32 motion-area mask in {0, 1}
    """

    def __init__(
        self,
        csv_path: str,
        video_folder: str,
        sample_size: int | tuple = 512,
        sample_stride: int = 4,
        sample_n_frames: int = 16,
        dynamic_fps: bool = True,
        is_image: bool = False,
        compute_motion_mask: bool = True,
        seed: Optional[int] = None,
    ):
        with open(csv_path) as f:
            self.rows = list(csv.DictReader(f))
        self.video_folder = video_folder
        if isinstance(sample_size, int):
            sample_size = (sample_size, sample_size)
        self.sample_size = tuple(sample_size)
        self.sample_stride = sample_stride
        self.sample_n_frames = sample_n_frames
        self.dynamic_fps = dynamic_fps
        self.is_image = is_image
        self.compute_motion_mask = compute_motion_mask
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.rows)

    def _get_batch(self, idx: int):
        row = self.rows[idx]
        path = os.path.join(self.video_folder, f"{row['videoid']}.mp4")
        stride = self.sample_stride
        if self.dynamic_fps:
            stride = self.rng.randint(2, 24)  # reference dataset.py:140-143

        length = _video_length_cv2(path)
        if length <= 0:
            raise IOError(f"empty video {path}")
        if self.is_image:
            batch_index = [self.rng.randint(0, length - 1)]
        else:
            framelst = list(range(0, length, stride))
            if len(framelst) < self.sample_n_frames:
                stride = max(1, length // (self.sample_n_frames + 1))
                framelst = list(range(0, length, stride))
            if len(framelst) > self.sample_n_frames:
                start = self.rng.randint(
                    0, len(framelst) - self.sample_n_frames)
            else:
                start = 0
            batch_index = framelst[start:start + self.sample_n_frames]
            if len(batch_index) < self.sample_n_frames:
                raise IOError(f"too few frames in {path}")

        frames = _read_frames_cv2(path, batch_index)
        return frames, row["name"], stride

    def _transform(self, frames: np.ndarray) -> np.ndarray:
        """Resize shorter side + center crop + normalize to [-1, 1]."""
        import cv2

        th, tw = self.sample_size
        f, h, w, _ = frames.shape
        scale = max(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        resized = np.stack([
            cv2.resize(fr, (nw, nh), interpolation=cv2.INTER_LINEAR)
            for fr in frames])
        top, left = (nh - th) // 2, (nw - tw) // 2
        crop = resized[:, top:top + th, left:left + tw]
        return crop.astype(np.float32) / 127.5 - 1.0

    def __getitem__(self, idx: int) -> Dict:
        for _ in range(100):  # bounded retry (reference retries forever)
            try:
                frames, name, stride = self._get_batch(idx)
                pixel_values = self._transform(frames)
                if self.is_image:
                    pixel_values = pixel_values[0]
                mask = None
                if self.compute_motion_mask and not self.is_image:
                    th, tw = self.sample_size
                    small = ((pixel_values + 1.0) * 127.5).astype(np.uint8)
                    mask = get_moved_area_mask(small)
                    mask = (mask > 127).astype(np.float32)[..., None]
                return dict(pixel_values=pixel_values, text=name,
                            ori_text=name, fps=float(stride), mask=mask)
            except Exception as e:  # corrupt video → resample another index
                print(f"[WebVidDataset] {e}; resampling")
                idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("too many corrupt samples")
