"""The port's host-side datasets against the JAX package's, on files the
test writes: a WebVid csv with an mp4 (a moving square) and a missing
video, an Arrow IPC shard of PNG images, an image folder with and without
a metadata jsonl, and their concatenation. Same seed, same index: the
samples must be equal (both are numpy on the host)."""

import csv
import json

import numpy as np
import pytest

from followyourclick_tpu.data import dataset as jds
from followyourclick_tpu.data import image_dataset as jimg
from followyourclick_tpu_torch.data import dataset as tds
from followyourclick_tpu_torch.data import image_dataset as timg

cv2 = pytest.importorskip("cv2")


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    h, w = 48, 64
    writer = cv2.VideoWriter(str(root / "v1.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for i in range(50):
        frame = np.full((h, w, 3), 30, np.uint8)
        frame[10:26, 4 + i // 2:14 + i // 2] = 210
        writer.write(frame)
    writer.release()
    csv_path = root / "meta.csv"
    with open(csv_path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=["videoid", "name"])
        wr.writeheader()
        wr.writerow({"videoid": "v1", "name": "a square moves"})
        wr.writerow({"videoid": "gone", "name": "missing"})
    return str(root), str(csv_path)


@pytest.mark.parametrize("kw", [
    dict(sample_size=32, sample_n_frames=8, dynamic_fps=True),
    dict(sample_size=(24, 40), sample_n_frames=6, dynamic_fps=False,
         sample_stride=3),
    dict(sample_size=32, is_image=True),
])
def test_webvid_matches_jax(videos, kw):
    root, csv_path = videos
    jd = jds.WebVidDataset(csv_path, root, seed=3, **kw)
    td = tds.WebVidDataset(csv_path, root, seed=3, **kw)
    assert len(jd) == len(td) == 2
    for idx in (0, 1, 0):  # 1 is missing: both resample from their rng
        a, b = jd[idx], td[idx]
        assert (a["mask"] is None) == (b["mask"] is None)
        same({k: v for k, v in a.items() if k != "mask"},
             {k: v for k, v in b.items() if k != "mask"})
        if a["mask"] is not None:
            np.testing.assert_array_equal(a["mask"], b["mask"])


def test_moved_area_mask_matches_jax():
    rs = np.random.RandomState(0)
    frames = np.repeat(rs.randint(0, 255, (1, 40, 40, 3), np.uint8), 5, 0)
    frames[2:, 5:20, 8:30] = 255
    np.testing.assert_array_equal(tds.get_moved_area_mask(frames),
                                  jds.get_moved_area_mask(frames))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(1)
    items = []
    for i, (h, w) in enumerate([(30, 50), (64, 40), (36, 36)]):
        img = rs.randint(0, 255, (h, w, 3), np.uint8)
        name = f"a_photo_{i}.png"
        cv2.imwrite(str(root / name), img)
        items.append({"file": name, "caption": f"caption {i}"})
    with open(root / "meta.jsonl", "w") as f:
        f.write("\n".join(json.dumps(it) for it in items) + "\n")
    return root, items


def test_image_folder_matches_jax(images):
    root, _ = images
    for meta in (None, str(root / "meta.jsonl")):
        jd = jimg.ImageFolderDataset(str(root), meta, sample_size=24, seed=0)
        td = timg.ImageFolderDataset(str(root), meta, sample_size=24, seed=0)
        assert len(jd) == len(td) == 3
        for i in range(3):
            same(jd[i], td[i])


def test_laion_arrow_and_concat_match_jax(images, tmp_path):
    pa = pytest.importorskip("pyarrow")
    root, items = images
    blobs = [cv2.imencode(".png", cv2.imread(str(root / it["file"])))[1]
             .tobytes() for it in items]
    table = pa.table({"image": blobs,
                      "caption": [it["caption"] for it in items]})
    path = tmp_path / "shard-0.arrow"
    with pa.OSFile(str(path), "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    glob_ = str(tmp_path / "shard-*.arrow")
    jd = jimg.LaionArrowDataset(glob_, sample_size=28, seed=0)
    td = timg.LaionArrowDataset(glob_, sample_size=28, seed=0)
    jf = jimg.ImageFolderDataset(str(root), sample_size=28, seed=0)
    tf = timg.ImageFolderDataset(str(root), sample_size=28, seed=0)
    jc, tc = jimg.ConcatDataset([jd, jf]), timg.ConcatDataset([td, tf])
    assert len(jc) == len(tc) == 6
    for i in range(6):
        same(jc[i], tc[i])
    with pytest.raises(FileNotFoundError):
        timg.LaionArrowDataset(str(tmp_path / "none-*.arrow"))
