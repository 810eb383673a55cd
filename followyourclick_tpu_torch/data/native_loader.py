"""The prefetching clip loader: a pool of decode threads over Python's cv2.

Port of ``followyourclick_tpu/data/native_loader.py``, the ctypes front-end
of ``native/frame_loader.cpp`` (the reference's decord + DataLoader worker
pool). Despite the name, kept so that a reader finds the counterpart, this
loader has no native code of its own: the C++ loader includes OpenCV's C++
headers and builds with ``pkg-config opencv4``, and the card's machine has
OpenCV only as the Python ``cv2`` package. So the same design runs on
Python threads: ``cv2.VideoCapture`` / ``imread`` / ``resize`` release the
GIL while they decode and resize, so ``num_workers`` threads decode in
parallel. It never builds anything, and writes nothing.

Semantics as ``frame_loader.cpp``:

- requests ``(path, frame_indices, out_hw, crop_mode)``, ids counting up
  from 0, the indices sorted; ``frame_indices=None`` reads one image;
- ``crop_mode`` 0 resizes the short side (each side ``side · scale + 0.5``
  truncated, at least the output's) and crops the centre, 1 resizes to the
  output; both ``INTER_LINEAR``, then BGR → RGB (``:53-73``);
- a clip is decoded by sequential grab / retrieve up to each index
  (``:176-191``);
- done plus in-flight decodes never exceed ``capacity`` (``:122-131``);
- a status a request: 0 ok, -1 the file did not open, -2 a frame out of
  range, -3 an exception while decoding; :meth:`NativeClipLoader.next`
  raises ``TimeoutError`` when no clip is ready in time and ``IOError``
  for a request that failed (``native_loader.py:91-98``). A clip that
  cannot be decoded is never replaced by another path's result.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

OK, OPEN_FAILED, OUT_OF_RANGE, DECODE_ERROR = 0, -1, -2, -3


def preprocess(bgr: np.ndarray, out_h: int, out_w: int,
               crop_mode: int) -> np.ndarray:
    """One decoded BGR frame → ``(out_h, out_w, 3)`` RGB uint8
    (``frame_loader.cpp::preprocess``)."""
    import cv2

    if crop_mode == 1:
        resized = cv2.resize(bgr, (out_w, out_h),
                             interpolation=cv2.INTER_LINEAR)
    else:
        rows, cols = bgr.shape[:2]
        scale = max(out_h / rows, out_w / cols)
        scaled = cv2.resize(bgr, (max(out_w, int(cols * scale + 0.5)),
                                  max(out_h, int(rows * scale + 0.5))),
                            interpolation=cv2.INTER_LINEAR)
        x = (scaled.shape[1] - out_w) // 2
        y = (scaled.shape[0] - out_h) // 2
        resized = scaled[y:y + out_h, x:x + out_w]
    return cv2.cvtColor(resized, cv2.COLOR_BGR2RGB)


def decode(path: str, frame_indices: Sequence[int], out_hw: Tuple[int, int],
           crop_mode: int) -> Tuple[int, Optional[np.ndarray]]:
    """``(status, frames (N, H, W, 3) uint8 or None)`` of one request
    (``frame_loader.cpp::Process``); an empty ``frame_indices`` reads one
    image."""
    import cv2

    out_h, out_w = out_hw
    try:
        if not frame_indices:
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                return OPEN_FAILED, None
            return OK, preprocess(img, out_h, out_w, crop_mode)[None]
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return OPEN_FAILED, None
        try:
            out = np.empty((len(frame_indices), out_h, out_w, 3), np.uint8)
            cur = 0
            for i, target in enumerate(frame_indices):
                while cur <= target:
                    if not cap.grab():
                        return OUT_OF_RANGE, None
                    cur += 1
                ok, frame = cap.retrieve()
                if not ok or frame is None or frame.size == 0:
                    return OUT_OF_RANGE, None
                out[i] = preprocess(frame, out_h, out_w, crop_mode)
            return OK, out
        finally:
            cap.release()
    except Exception:  # the C++ loader's catch (...)
        return DECODE_ERROR, None


class NativeClipLoader:
    """Submit ``(path, frame_indices, out_hw)`` requests; pop finished
    clips in the order they finish.

    crop_mode 0 = short-side resize + centre crop (WebVid semantics,
    ``dataset.py:168-178``); 1 = plain resize.
    """

    def __init__(self, num_workers: int = 4, capacity: int = 8):
        if num_workers < 1 or capacity < 1:
            raise ValueError("num_workers and capacity must be >= 1")
        self.capacity = capacity
        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._done: collections.deque = collections.deque()
        self._decoding = 0
        self._stop = False
        self._ids = itertools.count()
        self._workers = [threading.Thread(target=self._work, daemon=True,
                                          name=f"clip-loader-{i}")
                         for i in range(num_workers)]
        for t in self._workers:
            t.start()

    def submit(self, path: str, frame_indices: Optional[Sequence[int]],
               out_hw: Tuple[int, int], crop_mode: int = 0) -> int:
        """Enqueue one clip (video) or image (``frame_indices=None``);
        returns a request id."""
        rid = next(self._ids)
        idx = (() if frame_indices is None
               else tuple(sorted(int(i) for i in frame_indices)))
        with self._cv:
            if self._stop:
                raise RuntimeError("the loader is closed")
            self._pending.append((rid, str(path), idx,
                                  (int(out_hw[0]), int(out_hw[1])),
                                  int(crop_mode)))
            self._cv.notify_all()
        return rid

    def next(self, timeout_ms: int = 30000):
        """Blocking pop → ``(request_id, frames (N, H, W, 3) uint8)``;
        raises ``TimeoutError`` when nothing is done within ``timeout_ms``
        and ``IOError`` for a request that could not be decoded."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while not self._done and not self._stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            if not self._done:
                raise TimeoutError("native loader: no clip ready")
            rid, status, frames = self._done.popleft()
            self._cv.notify_all()  # a slot of the capacity is free
        if status != OK:
            raise IOError(f"native loader: decode failed (status {status}) "
                          f"for request {rid}")
        return rid, frames

    def _work(self) -> None:
        while True:
            with self._cv:
                # a slot is reserved here, under the lock, and released when
                # the result is popped: done + decoding <= capacity
                while not (self._stop or (
                        self._pending and len(self._done) + self._decoding
                        < self.capacity)):
                    self._cv.wait()
                if self._stop:
                    return
                rid, path, idx, out_hw, crop_mode = self._pending.popleft()
                self._decoding += 1
            status, frames = decode(path, idx, out_hw, crop_mode)
            with self._cv:
                self._done.append((rid, status, frames))
                self._decoding -= 1
                self._cv.notify_all()

    def close(self) -> None:
        """Stop the workers (a decode under way finishes first)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join()
        self._workers = []

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
