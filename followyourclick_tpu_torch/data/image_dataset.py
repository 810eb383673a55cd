"""Image datasets for joint image+video ("img_as_vid") training.

Port of ``followyourclick_tpu/data/image_dataset.py`` (numpy on the host;
``cv2`` and ``pyarrow`` imported where they are used, as there). Behavior
spec: reference ``animatediff/data/image_dataset.py`` —
``LaionDataset`` (Arrow-shard reader, :35-129), LAION-Aesthetic metadata
reader (:131-206), ``AllImageDataset`` concat (:208-227). Images are treated
as 1-frame videos (the config name's ``img_as_vid``). Retry-on-error
resampling mirrors :92-98.
"""

from __future__ import annotations

import glob
import json
import os
import random
from typing import Dict, List, Optional

import numpy as np


def _to_pixel_values(img: np.ndarray, size: int) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    scale = max(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    top, left = (nh - size) // 2, (nw - size) // 2
    img = img[top:top + size, left:left + size]
    return img.astype(np.float32) / 127.5 - 1.0


class LaionArrowDataset:
    """Arrow-IPC shard reader: each shard holds ``image`` (encoded bytes) and
    ``caption`` columns (the reference's pyarrow path)."""

    def __init__(self, shard_glob: str, sample_size: int = 512,
                 image_column: str = "image", caption_column: str = "caption",
                 seed: Optional[int] = None):
        self.files = sorted(glob.glob(shard_glob))
        if not self.files:
            raise FileNotFoundError(f"no arrow shards match {shard_glob}")
        self.sample_size = sample_size
        self.image_column = image_column
        self.caption_column = caption_column
        self.rng = random.Random(seed)
        self._tables = {}
        self._index: List[tuple] = []
        import pyarrow as pa

        for fi, path in enumerate(self.files):
            with pa.memory_map(path) as source:
                table = pa.ipc.open_file(source).read_all()
            self._tables[fi] = table
            self._index.extend((fi, ri) for ri in range(table.num_rows))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> Dict:
        import cv2

        for _ in range(100):
            try:
                fi, ri = self._index[idx]
                table = self._tables[fi]
                raw = table[self.image_column][ri].as_py()
                if isinstance(raw, dict):  # HF image struct {bytes, path}
                    raw = raw["bytes"]
                buf = np.frombuffer(raw, dtype=np.uint8)
                img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                caption = str(table[self.caption_column][ri].as_py())
                pixel = _to_pixel_values(img, self.sample_size)
                return dict(pixel_values=pixel[None],  # 1-frame video
                            text=caption, fps=0.0, mask=None)
            except Exception as e:
                print(f"[LaionArrowDataset] {e}; resampling")
                idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("too many corrupt samples")


class ImageFolderDataset:
    """Metadata-jsonl/folder image reader (LAION-Aesthetic style: a jsonl of
    {file, caption} or plain image files with filename captions)."""

    def __init__(self, root: str, metadata_jsonl: Optional[str] = None,
                 sample_size: int = 512, seed: Optional[int] = None):
        self.root = root
        self.sample_size = sample_size
        self.rng = random.Random(seed)
        if metadata_jsonl:
            with open(metadata_jsonl) as f:
                self.items = [json.loads(line) for line in f if line.strip()]
        else:
            exts = (".jpg", ".jpeg", ".png", ".webp")
            self.items = [
                {"file": p, "caption":
                 os.path.splitext(os.path.basename(p))[0].replace("_", " ")}
                for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                                          recursive=True))
                if p.lower().endswith(exts)]
        if not self.items:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        import cv2

        for _ in range(100):
            try:
                item = self.items[idx]
                path = item["file"]
                if not os.path.isabs(path):
                    path = os.path.join(self.root, path)
                img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
                pixel = _to_pixel_values(img, self.sample_size)
                return dict(pixel_values=pixel[None], text=item["caption"],
                            fps=0.0, mask=None)
            except Exception as e:
                print(f"[ImageFolderDataset] {e}; resampling")
                idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("too many corrupt samples")


class ConcatDataset:
    """AllImageDataset equivalent (reference image_dataset.py:208-227)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, idx: int) -> Dict:
        di = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self.offsets[di])]
