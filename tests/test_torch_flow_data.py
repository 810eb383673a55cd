"""The port's flow file codecs, dataset readers and batch iterator against
the JAX package's, on synthetic files written here with OpenCV (the JAX
side's reader).

Every reader (FlyingChairs with its split file, Sintel, KITTI,
FlyingThings3D, its subset, ChairsSDHom, HD1K, FlyingChairsOcc with its
occlusion masks, their concatenation) gives the JAX reader's samples bit
for bit: the port reads PNG and PPM with PIL and 16-bit PNGs with its own
decoder, where JAX uses ``cv2.imread``. ``training_batches`` (crop, flips,
jitter) gives the JAX batches for one seed.
"""

import cv2
import numpy as np
import pytest

from followyourclick_tpu.flow import datasets as jdata
from followyourclick_tpu.flow import flow_io as jio
from followyourclick_tpu_torch.flow import datasets as tdata
from followyourclick_tpu_torch.flow import flow_io as tio

SIZE = (20, 28)   # (H, W) of the synthetic images


def _img(rs, h=SIZE[0], w=SIZE[1]):
    # smooth rows and columns plus noise, so every PNG filter type occurs
    base = (np.arange(h)[:, None, None] * 5 + np.arange(w)[None, :, None] * 3
            + np.arange(3) * 40)
    return ((base + rs.randint(0, 60, (h, w, 3))) % 256).astype(np.uint8)


def _flow(rs, h=SIZE[0], w=SIZE[1]):
    return (4 * rs.randn(h, w, 2)).astype(np.float32)


def _kitti_png(rs, path, h=SIZE[0], w=SIZE[1]):
    valid = (rs.rand(h, w) > 0.3).astype(np.float32)
    png = jio.flow_to_kitti_png(_flow(rs, h, w), valid)
    cv2.imwrite(str(path), png[..., ::-1])   # (u, v, valid) as RGB


def write_chairs(root, n, seed=0, split=False):
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        cv2.imwrite(str(root / f"{i:05d}_img1.ppm"), _img(rs))
        cv2.imwrite(str(root / f"{i:05d}_img2.ppm"), _img(rs))
        jio.write_flow(_flow(rs), root / f"{i:05d}_flow.flo")
    if split:
        np.savetxt(root / "split.txt", (np.arange(n) % 3 == 2) + 1,
                   fmt="%d")
    return root


def _sintel(root, rs):
    for scene in ("alley", "bamboo"):
        for i in range(3):
            d = root / "clean" / scene
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / f"frame_{i:04d}.png"), _img(rs))
            if i < 2:
                f = root / "flow" / scene
                f.mkdir(parents=True, exist_ok=True)
                jio.write_flow(_flow(rs), f / f"frame_{i:04d}.flo")
    return {}


def _kitti(root, rs):
    for d in ("image_2", "flow_occ"):
        (root / d).mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(root / "image_2" / f"{i:06d}_10.png"), _img(rs))
        cv2.imwrite(str(root / "image_2" / f"{i:06d}_11.png"), _img(rs))
        _kitti_png(rs, root / "flow_occ" / f"{i:06d}_10.png")
    return {}


def _things(root, rs):
    seq = "TRAIN/A/0000"
    img = root / "frames_cleanpass" / seq / "left"
    img.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(img / f"{i:04d}.png"), _img(rs))
    for sub in ("into_future", "into_past"):
        d = root / "optical_flow" / seq / sub / "left"
        d.mkdir(parents=True)
        for i in range(3):
            jio.write_pfm(np.concatenate(
                [_flow(rs), np.zeros(SIZE + (1,), np.float32)], -1),
                d / f"{i:04d}.pfm")
    return {}


def _things_subset(root, rs):
    base = root / "train"
    img = base / "image_clean" / "left"
    img.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(img / f"{i:07d}.png"), _img(rs))
    for sub in ("into_future", "into_past"):
        d = base / "flow" / "left" / sub
        d.mkdir(parents=True)
        for i in range(3):
            jio.write_flow(_flow(rs), d / f"{i:07d}.flo")
    return {}


def _sdhom(root, rs):
    base = root / "data" / "train"
    for d in ("t0", "t1", "flow"):
        (base / d).mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(base / "t0" / f"{i:05d}.png"), _img(rs))
        cv2.imwrite(str(base / "t1" / f"{i:05d}.png"), _img(rs))
        jio.write_pfm(np.concatenate(
            [_flow(rs), np.zeros(SIZE + (1,), np.float32)], -1),
            base / "flow" / f"{i:05d}.pfm")
    return {}


def _hd1k(root, rs):
    img = root / "hd1k_input" / "image_2"
    flo = root / "hd1k_flow_gt" / "flow_occ"
    img.mkdir(parents=True)
    flo.mkdir(parents=True)
    for seq in range(2):
        for i in range(3):
            cv2.imwrite(str(img / f"{seq:06d}_{i:04d}.png"), _img(rs))
            _kitti_png(rs, flo / f"{seq:06d}_{i:04d}.png")
    return {}


def _chairs_occ(root, rs):
    d = root / "data"
    d.mkdir(parents=True)
    for i in range(7):   # index 5 is in the official validation split
        cv2.imwrite(str(d / f"{i:05d}_img1.png"), _img(rs))
        cv2.imwrite(str(d / f"{i:05d}_img2.png"), _img(rs))
        jio.write_flow(_flow(rs), d / f"{i:05d}_flow.flo")
        cv2.imwrite(str(d / f"{i:05d}_occ1.png"),
                    (rs.rand(*SIZE) > 0.5).astype(np.uint8) * 255)
    return {}


def _chairs(root, rs):
    write_chairs(root, 6, split=True)
    return {"split_file": str(root / "split.txt")}


READERS = {
    "FlyingChairs": (_chairs, [{}, {"test_mode": True}]),
    "Sintel": (_sintel, [{}]),
    "KITTI": (_kitti, [{}]),
    "FlyingThings3D": (_things, [{}, {"direction": "forward"}]),
    "FlyingThings3DSubset": (_things_subset, [{}, {"direction":
                                                   "backward"}]),
    "ChairsSDHom": (_sdhom, [{}]),
    "HD1K": (_hd1k, [{}]),
    "FlyingChairsOcc": (_chairs_occ, [{}, {"test_mode": True}]),
}


def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        for field in ("img1", "img2", "flow_gt", "valid"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=f"{i} {field}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_equals_jax(name, tmp_path):
    write, variants = READERS[name]
    extra = write(tmp_path, np.random.RandomState(3))
    for kw in variants:
        kw = {**extra, **kw}
        got = getattr(tdata, name)(str(tmp_path), **kw)
        want = getattr(jdata, name)(str(tmp_path), **kw)
        assert [tuple(map(str, r)) for r in got.records] == \
            [tuple(map(str, r)) for r in want.records]
        _assert_samples_equal(got, want)
    if name == "FlyingChairsOcc":
        for i in range(len(got)):
            np.testing.assert_array_equal(got.occlusion(i),
                                          want.occlusion(i))


def test_concat_and_mixed_dataset(tmp_path):
    write_chairs(tmp_path / "a", 3, seed=0)
    write_chairs(tmp_path / "b", 2, seed=1)
    got = tdata.mixed_dataset([tdata.FlyingChairs(str(tmp_path / "a")),
                               tdata.FlyingChairs(str(tmp_path / "b"))],
                              [2.0, 1.0])
    want = jdata.mixed_dataset([jdata.FlyingChairs(str(tmp_path / "a")),
                                jdata.FlyingChairs(str(tmp_path / "b"))],
                               [2.0, 1.0])
    assert got.weights == want.weights and len(got) == 5
    _assert_samples_equal(got, want)


@pytest.mark.parametrize("augment", [True, False])
def test_training_batches_equal_jax(augment, tmp_path):
    write_chairs(tmp_path, 5, seed=2)
    got = tdata.training_batches(tdata.FlyingChairs(str(tmp_path)), 2,
                                 (16, 24), seed=7, augment=augment)
    want = jdata.training_batches(jdata.FlyingChairs(str(tmp_path)), 2,
                                  (16, 24), seed=7, augment=augment)
    for _ in range(4):   # past one epoch: the second permutation too
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "ppm", "rgb16",
                                  "rgba16", "gray16", "palette"])
def test_imread_equals_cv2(kind, tmp_path):
    rs = np.random.RandomState(4)
    img = _img(rs)
    path = tmp_path / ("x.ppm" if kind == "ppm" else "x.png")
    if kind == "rgba":
        img = np.concatenate([img, rs.randint(0, 256, SIZE + (1,))
                              .astype(np.uint8)], -1)
    elif kind == "gray":
        img = img[..., 0]
    elif kind.endswith("16"):
        img = img.astype(np.uint16) * 257 + rs.randint(0, 257, img.shape
                                                       ).astype(np.uint16)
        if kind == "rgba16":
            img = np.concatenate([img, img[..., :1]], -1)
        elif kind == "gray16":
            img = img[..., 0]
    if kind == "palette":
        from PIL import Image

        Image.fromarray(img).quantize(16).save(path)
    else:
        cv2.imwrite(str(path), img)
    depth = tio.png_bit_depth(path)
    assert depth is None if kind == "ppm" else \
        (depth == 16) == kind.endswith("16")
    np.testing.assert_array_equal(tdata._imread(path), jdata._imread(path))
    with pytest.raises(FileNotFoundError):
        tdata._imread(tmp_path / "missing.png")


def test_flow_codecs_cross(tmp_path):
    rs = np.random.RandomState(5)
    flow = _flow(rs)
    tio.write_flow(flow, tmp_path / "a.flo")
    np.testing.assert_array_equal(jio.read_flow(tmp_path / "a.flo"), flow)
    pfm = rs.randn(*SIZE, 3).astype(np.float32)
    tio.write_pfm(pfm, tmp_path / "a.pfm")
    for reader in (jio.read_pfm, tio.read_pfm):
        data, scale = reader(tmp_path / "a.pfm")
        np.testing.assert_array_equal(data, pfm)
        assert scale == 1.0
    valid = (rs.rand(*SIZE) > 0.5).astype(np.float32)
    png = tio.flow_to_kitti_png(flow, valid)
    np.testing.assert_array_equal(png, jio.flow_to_kitti_png(flow, valid))
    cv2.imwrite(str(tmp_path / "k.png"), png[..., ::-1])
    np.testing.assert_array_equal(tio.read_png16(tmp_path / "k.png"), png)
    for got, want in zip(tio.read_kitti_flow(png), jio.read_kitti_flow(png)):
        np.testing.assert_array_equal(got, want)
