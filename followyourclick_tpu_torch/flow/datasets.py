"""Flow dataset readers and training transforms.

Port of ``followyourclick_tpu/flow/datasets.py`` (mmflow's FlyingChairs,
Sintel, KITTI 2012/2015, FlyingThings3D and its subset, ChairsSDHom, HD1K
and FlyingChairsOcc datasets, the random crop, flips and photometric
jitter, and the shuffled batch iterator), on the host in numpy, with the
JAX ``RandomState`` draws in the same order.

The JAX readers use ``cv2.imread(IMREAD_UNCHANGED)`` with the channels
reversed to RGB; the port has no OpenCV, so :func:`_imread` reads with PIL
(8-bit PNG, PPM; alpha dropped as ``COLOR_BGRA2RGB`` drops it) and 16-bit
PNGs, which PIL narrows to 8 bits, with ``flow_io.read_png16`` (KITTI's and
HD1K's flows, in their (u, v, valid) order)."""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from followyourclick_tpu_torch.flow.flow_io import (
    png_bit_depth,
    read_flow,
    read_kitti_flow,
    read_pfm,
    read_png16,
)


def _imread(path) -> np.ndarray:
    """An image as ``cv2.imread(path, IMREAD_UNCHANGED)`` followed by the
    JAX reader's BGR(A) → RGB: gray stays 2-D, alpha is dropped, 16-bit
    PNGs stay uint16."""
    if png_bit_depth(path) == 16:
        img = read_png16(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode not in ("L", "RGB", "RGBA"):
                im = im.convert("RGB")
            img = np.asarray(im)
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    return np.ascontiguousarray(img)


@dataclasses.dataclass
class FlowSample:
    img1: np.ndarray       # (H, W, 3) uint8
    img2: np.ndarray
    flow_gt: np.ndarray    # (H, W, 2) float32
    valid: np.ndarray      # (H, W) float32


class FlyingChairs:
    """data_root/NNNNN_img1.ppm, _img2.ppm, _flow.flo (+ optional split file
    of 1/2 per line: 1=train, 2=val — mmflow FlyingChairs dataset)."""

    def __init__(self, data_root: str, split_file: Optional[str] = None,
                 test_mode: bool = False):
        root = Path(data_root)
        flows = sorted(root.glob("*_flow.flo"))
        keep = None
        if split_file and os.path.exists(split_file):
            marks = np.loadtxt(split_file, dtype=int)
            want = 2 if test_mode else 1
            keep = {i for i, m in enumerate(marks) if m == want}
        self.records = [
            (str(f)[: -len("_flow.flo")] + "_img1.ppm",
             str(f)[: -len("_flow.flo")] + "_img2.ppm", str(f))
            for i, f in enumerate(flows)
            if keep is None or i in keep
        ]

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        p1, p2, pf = self.records[i]
        flow = read_flow(pf)
        return FlowSample(
            _imread(p1), _imread(p2), flow,
            np.ones(flow.shape[:2], np.float32),
        )


class Sintel:
    """data_root/{clean|final}/scene/frame_NNNN.png consecutive pairs with
    data_root/flow/scene/frame_NNNN.flo (mmflow Sintel dataset)."""

    def __init__(self, data_root: str, pass_name: str = "clean"):
        root = Path(data_root)
        self.records = []
        img_root = root / pass_name
        for scene in sorted(p for p in img_root.iterdir() if p.is_dir()):
            frames = sorted(scene.glob("*.png"))
            for a, b in zip(frames[:-1], frames[1:]):
                flo = root / "flow" / scene.name / (a.stem + ".flo")
                if flo.exists():
                    self.records.append((a, b, flo))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, flo = self.records[i]
        flow = read_flow(flo)
        return FlowSample(
            _imread(a), _imread(b), flow,
            np.ones(flow.shape[:2], np.float32),
        )


class KITTI:
    """data_root/image_2/NNNNNN_1{0,1}.png pairs + flow_occ 16-bit PNGs
    (mmflow KITTI2012/2015 datasets)."""

    def __init__(self, data_root: str):
        root = Path(data_root)
        self.records = []
        for f in sorted((root / "flow_occ").glob("*_10.png")):
            stem = f.name[: -len("_10.png")]
            a = root / "image_2" / f"{stem}_10.png"
            b = root / "image_2" / f"{stem}_11.png"
            if a.exists() and b.exists():
                self.records.append((a, b, f))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, f = self.records[i]
        # KITTI stores (u, v, valid) in (R, G, B)
        flow, valid = read_kitti_flow(read_png16(f))
        return FlowSample(
            _imread(a), _imread(b), flow.astype(np.float32),
            valid.astype(np.float32),
        )


def _read_pfm_flow(path) -> np.ndarray:
    data, _ = read_pfm(path)
    if data.ndim == 3:
        data = data[..., :2]
    return np.ascontiguousarray(data.astype(np.float32))


class FlyingThings3D:
    """Full FlyingThings3D (mmflow ``datasets/flyingthings3d.py``):
    ``data_root/frames_{clean,final}pass/{TRAIN,TEST}/<set>/<seq>/<scene>/
    *.png`` with ``optical_flow/{TRAIN,TEST}/<set>/<seq>/into_{future,past}
    /<scene>/*.pfm``.

    ``direction``: 'forward' pairs (i, i+1) with flow_fw[i]; 'backward' pairs
    (i+1, i) with flow_bw[i+1]; the default ['forward','backward'] is their
    union (the RAFT C+T recipe). ``scene`` defaults to 'left' as upstream.
    """

    def __init__(self, data_root: str, pass_style: str = "clean",
                 scene: str = "left", test_mode: bool = False,
                 direction="both"):
        root = Path(data_root)
        subset = "TEST" if test_mode else "TRAIN"
        pass_dir = f"frames_{pass_style}pass"
        self.records = []
        img_base = root / pass_dir / subset
        flow_base = root / "optical_flow" / subset
        if not img_base.exists():
            return
        for seq_dir in sorted(img_base.glob("*/*")):
            rel = seq_dir.relative_to(img_base)
            imgs = sorted((seq_dir / scene).glob("*.png"))
            fw = sorted((flow_base / rel / "into_future" / scene
                         ).glob("*.pfm"))
            bw = sorted((flow_base / rel / "into_past" / scene).glob("*.pfm"))
            if direction in ("forward", "both"):
                for i in range(len(imgs) - 1):
                    if i < len(fw):
                        self.records.append((imgs[i], imgs[i + 1], fw[i]))
            if direction in ("backward", "both"):
                for i in range(1, len(imgs)):
                    if i < len(bw):
                        self.records.append((imgs[i], imgs[i - 1], bw[i]))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, pf = self.records[i]
        flow = _read_pfm_flow(pf)
        return FlowSample(_imread(a), _imread(b), flow,
                          np.ones(flow.shape[:2], np.float32))


# .flo files containing NaNs, excluded upstream
# (mmflow flyingthings3d_subset.py exclude_files)
_FT3DS_EXCLUDE = {
    ("left", "into_future"): {
        "0004573.flo", "0006336.flo", "0016948.flo", "0015148.flo",
        "0006922.flo", "0003147.flo", "0003149.flo", "0000879.flo",
        "0006337.flo", "0014658.flo", "0015748.flo", "0001717.flo",
        "0000119.flo", "0017578.flo", "0004118.flo", "0004117.flo",
        "0004304.flo", "0004154.flo", "0011530.flo"},
    ("right", "into_future"): {
        "0006336.flo", "0003148.flo", "0004117.flo", "0003666.flo"},
    ("left", "into_past"): {
        "0000162.flo", "0004705.flo", "0006878.flo", "0004876.flo",
        "0004045.flo", "0000053.flo", "0005055.flo", "0000163.flo",
        "0000161.flo", "0000121.flo", "0000931.flo", "0005054.flo"},
    ("right", "into_past"): {
        "0006878.flo", "0003147.flo", "0001549.flo", "0000053.flo",
        "0005034.flo", "0003148.flo", "0005055.flo", "0000161.flo",
        "0001648.flo", "0000160.flo", "0005054.flo"},
}


class FlyingThings3DSubset:
    """FlyingThings3D *subset* (mmflow ``flyingthings3d_subset.py``):
    ``data_root/{train,val}/image_clean/<scene>/*.png`` with
    ``flow/<scene>/into_{future,past}/*.flo`` and occlusion masks under
    ``flow_occlusions``. Forward flow ``N.flo`` pairs (N, N+1); backward
    pairs (N, N-1) sampled as (img2→img1). NaN-bearing flows are excluded
    per the upstream lists."""

    def __init__(self, data_root: str, scene: str = "left",
                 test_mode: bool = False, direction: str = "both"):
        root = Path(data_root) / ("val" if test_mode else "train")
        img_dir = root / "image_clean" / scene
        flow_dir = root / "flow" / scene
        occ_dir = root / "flow_occlusions" / scene
        self.records = []
        if not img_dir.exists():
            return

        def add(flow_sub: str, off: int):
            exclude = _FT3DS_EXCLUDE.get((scene, flow_sub), set())
            for flo in sorted((flow_dir / flow_sub).glob("*.flo")):
                if flo.name in exclude:
                    continue
                idx = int(flo.stem)
                a = img_dir / f"{idx:07d}.png"
                b = img_dir / f"{idx + off:07d}.png"
                occ = occ_dir / flow_sub / f"{idx:07d}.png"
                if a.exists() and b.exists():
                    self.records.append((a, b, flo,
                                         occ if occ.exists() else None))

        if direction in ("forward", "both"):
            add("into_future", +1)
        if direction in ("backward", "both"):
            add("into_past", -1)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, flo, occ = self.records[i]
        flow = read_flow(flo)
        valid = np.ones(flow.shape[:2], np.float32)
        return FlowSample(_imread(a), _imread(b), flow, valid)


class ChairsSDHom:
    """ChairsSDHom (mmflow ``chairssdhom.py``): small-displacement chairs —
    ``data_root/data/{train,test}/{t0,t1,flow}`` with ``NNNNN.png`` image
    pairs and ``NNNNN.pfm`` flows; ``08755.pfm`` excluded (NaNs upstream)."""

    _EXCLUDE = {"08755.pfm"}

    def __init__(self, data_root: str, test_mode: bool = False):
        root = Path(data_root) / "data" / ("test" if test_mode else "train")
        self.records = []
        for pf in sorted((root / "flow").glob("*.pfm")):
            if pf.name in self._EXCLUDE:
                continue
            idx = int(pf.stem)
            a = root / "t0" / f"{idx:05d}.png"
            b = root / "t1" / f"{idx:05d}.png"
            if a.exists() and b.exists():
                self.records.append((a, b, pf))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, pf = self.records[i]
        flow = _read_pfm_flow(pf)
        return FlowSample(_imread(a), _imread(b), flow,
                          np.ones(flow.shape[:2], np.float32))


class HD1K:
    """HD1K (mmflow ``hd1k.py``): ``hd1k_input/image_2/SSSSSS_FFFF.png``
    frame sequences with KITTI-format 16-bit flow PNGs under
    ``hd1k_flow_gt/flow_occ``; consecutive frames within each sequence pair
    up (the sparse-gt stage of the RAFT C+T+S+K+H mix)."""

    def __init__(self, data_root: str):
        root = Path(data_root)
        img_dir = root / "hd1k_input" / "image_2"
        flow_dir = root / "hd1k_flow_gt" / "flow_occ"
        self.records = []
        seq = 0
        while True:
            flows = sorted(flow_dir.glob(f"{seq:06d}_*.png"))
            images = sorted(img_dir.glob(f"{seq:06d}_*.png"))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.records.append((images[i], images[i + 1], flows[i]))
            seq += 1

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, f = self.records[i]
        flow, valid = read_kitti_flow(read_png16(f))
        return FlowSample(_imread(a), _imread(b), flow.astype(np.float32),
                          valid.astype(np.float32))


# official train/val split: indices marked validation out of the 22872
# samples (mmflow flyingchairsocc.py VALIDATE_INDICES, stored compactly)
_FCO_VALIDATE_INDICES = frozenset(int(x) for x in (
    "5,17,42,45,58,62,96,111,117,120,121,131,132,152,160,248,263,264,291,"
    "293,295,299,316,320,336,337,343,358,399,401,429,438,468,476,494,509,"
    "528,531,572,581,583,588,593,681,688,696,714,767,786,810,825,836,841,"
    "883,917,937,942,970,974,980,1016,1043,1064,1118,1121,1133,1153,1155,"
    "1158,1159,1173,1187,1219,1237,1238,1259,1266,1278,1296,1354,1378,1387,"
    "1494,1508,1518,1574,1601,1614,1668,1673,1699,1712,1714,1737,1841,1872,"
    "1879,1901,1921,1934,1961,1967,1978,2018,2030,2039,2043,2061,2113,2204,"
    "2216,2236,2250,2274,2292,2310,2342,2359,2374,2382,2399,2415,2419,2483,"
    "2502,2504,2576,2589,2590,2622,2624,2636,2651,2655,2658,2659,2664,2672,"
    "2706,2707,2709,2725,2732,2761,2827,2864,2866,2905,2922,2929,2966,2972,"
    "2993,3010,3025,3031,3040,3041,3070,3113,3124,3129,3137,3141,3157,3183,"
    "3206,3219,3247,3253,3272,3276,3321,3328,3333,3338,3341,3346,3351,3396,"
    "3419,3430,3433,3448,3455,3463,3503,3526,3529,3537,3555,3577,3584,3591,"
    "3594,3597,3603,3613,3615,3670,3676,3678,3697,3723,3728,3734,3745,3750,"
    "3752,3779,3782,3813,3817,3819,3854,3885,3944,3947,3970,3985,4011,4022,"
    "4071,4075,4132,4158,4167,4190,4194,4207,4246,4249,4298,4307,4317,4318,"
    "4319,4320,4382,4399,4401,4407,4416,4423,4484,4491,4493,4517,4525,4538,"
    "4578,4606,4609,4620,4623,4637,4646,4662,4668,4716,4739,4747,4770,4774,"
    "4776,4785,4800,4845,4863,4891,4904,4922,4925,4956,4963,4964,4994,5011,"
    "5019,5036,5038,5041,5055,5118,5122,5130,5162,5164,5178,5196,5227,5266,"
    "5270,5273,5279,5299,5310,5314,5363,5375,5384,5393,5414,5417,5433,5448,"
    "5494,5505,5509,5525,5566,5581,5602,5609,5620,5653,5670,5678,5690,5700,"
    "5703,5724,5752,5765,5803,5811,5860,5881,5895,5912,5915,5940,5952,5966,"
    "5977,5988,6007,6037,6061,6069,6080,6111,6127,6146,6161,6166,6168,6178,"
    "6182,6190,6220,6235,6253,6270,6343,6372,6379,6410,6411,6442,6453,6481,"
    "6498,6500,6509,6532,6541,6543,6560,6576,6580,6594,6595,6609,6625,6629,"
    "6644,6658,6673,6680,6698,6699,6702,6705,6741,6759,6785,6792,6794,6809,"
    "6810,6830,6838,6869,6871,6889,6925,6995,7003,7026,7029,7080,7082,7097,"
    "7102,7116,7165,7200,7232,7271,7282,7324,7333,7335,7372,7387,7407,7472,"
    "7474,7482,7489,7499,7516,7533,7536,7566,7620,7654,7691,7704,7722,7746,"
    "7750,7773,7806,7821,7827,7851,7873,7880,7884,7904,7912,7948,7964,7965,"
    "7984,7989,7992,8035,8050,8074,8091,8094,8113,8116,8151,8159,8171,8179,"
    "8194,8195,8239,8263,8290,8295,8312,8367,8374,8387,8407,8437,8439,8518,"
    "8556,8588,8597,8601,8651,8657,8723,8759,8763,8785,8802,8813,8826,8854,"
    "8856,8866,8918,8922,8923,8932,8958,8967,9003,9018,9078,9095,9104,9112,"
    "9129,9147,9170,9171,9197,9200,9249,9253,9270,9282,9288,9295,9321,9323,"
    "9324,9347,9399,9403,9417,9426,9427,9439,9468,9486,9496,9511,9516,9518,"
    "9529,9557,9563,9564,9584,9586,9591,9599,9600,9601,9632,9654,9667,9678,"
    "9696,9716,9723,9740,9820,9824,9825,9828,9863,9866,9868,9889,9929,9938,"
    "9953,9967,10019,10020,10025,10059,10111,10118,10125,10174,10194,10201,"
    "10202,10220,10221,10226,10242,10250,10276,10295,10302,10305,10327,"
    "10351,10360,10369,10393,10407,10438,10455,10463,10465,10470,10478,"
    "10503,10508,10509,10809,11080,11331,11607,11610,11864,12390,12393,"
    "12396,12399,12671,12921,12930,13178,13453,13717,14499,14517,14775,"
    "15297,15556,15834,15839,16126,16127,16386,16633,16644,16651,17166,"
    "17169,17958,17959,17962,18224,21176,21180,21190,21802,21803,21806,"
    "22584,22857,22858,22866").split(","))


class FlyingChairsOcc:
    """FlyingChairsOcc (mmflow ``flyingchairsocc.py``): FlyingChairs with
    bidirectional flow + occlusion masks —
    ``data_root/data/NNNNN_{img1,img2}.png, _flow.flo, _flow_b.flo,
    _occ1.png, _occ2.png``; built-in official train/val split."""

    def __init__(self, data_root: str, test_mode: bool = False):
        root = Path(data_root) / "data"
        self.records = []
        flows = sorted(root.glob("*_flow.flo"))
        for i, pf in enumerate(flows):
            is_val = i in _FCO_VALIDATE_INDICES
            if is_val != test_mode:
                continue
            stem = str(pf)[: -len("_flow.flo")]
            a, b = stem + "_img1.png", stem + "_img2.png"
            occ = stem + "_occ1.png"
            if os.path.exists(a) and os.path.exists(b):
                self.records.append((a, b, str(pf),
                                     occ if os.path.exists(occ) else None))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> FlowSample:
        a, b, pf, occ = self.records[i]
        flow = read_flow(pf)
        valid = np.ones(flow.shape[:2], np.float32)
        return FlowSample(_imread(a), _imread(b), flow, valid)

    def occlusion(self, i) -> Optional[np.ndarray]:
        """Forward occlusion mask (H, W) float32 in {0,1}, or None."""
        occ = self.records[i][3]
        if occ is None:
            return None
        m = _imread(occ)
        if m.ndim == 3:
            m = m[..., 0]
        return (m > 127).astype(np.float32)


class ConcatFlowDataset:
    """Concatenation of flow datasets with per-dataset sampling weights —
    the map-style half of mmflow's MixedBatchDistributedSampler recipe
    (weights consumed by ``flow.train.mixed_training_batches``); makes the
    RAFT C+T+S+K+H mixed stage constructible."""

    def __init__(self, datasets: Sequence, weights: Optional[Sequence[float]]
                 = None):
        self.datasets = list(datasets)
        self.weights = (list(weights) if weights is not None
                        else [1.0] * len(self.datasets))
        assert len(self.weights) == len(self.datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i) -> FlowSample:
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self._offsets[k])]


def mixed_dataset(datasets: Sequence, weights: Optional[Sequence[float]]
                  = None) -> ConcatFlowDataset:
    return ConcatFlowDataset(datasets, weights)


# ------------------------------------------------------------ transforms --


def random_crop(sample: FlowSample, size, rng: np.random.RandomState
                ) -> FlowSample:
    ch, cw = size
    h, w = sample.img1.shape[:2]
    y = rng.randint(0, max(h - ch, 0) + 1)
    x = rng.randint(0, max(w - cw, 0) + 1)
    return FlowSample(
        sample.img1[y : y + ch, x : x + cw],
        sample.img2[y : y + ch, x : x + cw],
        sample.flow_gt[y : y + ch, x : x + cw],
        sample.valid[y : y + ch, x : x + cw],
    )


def random_flip(sample: FlowSample, rng: np.random.RandomState,
                p_h: float = 0.5, p_v: float = 0.1) -> FlowSample:
    img1, img2, flow, valid = (sample.img1, sample.img2, sample.flow_gt,
                               sample.valid)
    if rng.rand() < p_h:
        img1 = img1[:, ::-1]
        img2 = img2[:, ::-1]
        flow = flow[:, ::-1] * np.asarray([-1.0, 1.0], np.float32)
        valid = valid[:, ::-1]
    if rng.rand() < p_v:
        img1 = img1[::-1]
        img2 = img2[::-1]
        flow = flow[::-1] * np.asarray([1.0, -1.0], np.float32)
        valid = valid[::-1]
    return FlowSample(np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                      np.ascontiguousarray(flow), np.ascontiguousarray(valid))


def photometric_jitter(sample: FlowSample, rng: np.random.RandomState,
                       strength: float = 0.2) -> FlowSample:
    def jit(img):
        img = img.astype(np.float32)
        img = img * (1 + (rng.rand() - 0.5) * 2 * strength)  # brightness
        img = img + (rng.rand(3) - 0.5) * 20 * strength      # per-channel
        return np.clip(img, 0, 255).astype(np.uint8)

    return FlowSample(jit(sample.img1), jit(sample.img2), sample.flow_gt,
                      sample.valid)


def training_batches(
    dataset,
    batch_size: int,
    crop_size=(368, 496),
    seed: int = 0,
    augment: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled batch iterator feeding ``flow.train.train_step``
    (the DataLoader + DistributedSampler role, on the host): NHWC numpy,
    images float32 in [0, 255]."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    order = rng.permutation(n)
    pos = 0
    while True:
        batch: List[FlowSample] = []
        while len(batch) < batch_size:
            if pos >= n:
                order = rng.permutation(n)
                pos = 0
            s = dataset[int(order[pos])]
            pos += 1
            s = random_crop(s, crop_size, rng)
            if augment:
                s = random_flip(s, rng)
                s = photometric_jitter(s, rng)
            batch.append(s)
        yield {
            "img1": np.stack([s.img1 for s in batch]).astype(np.float32),
            "img2": np.stack([s.img2 for s in batch]).astype(np.float32),
            "flow_gt": np.stack([s.flow_gt for s in batch]),
            "valid": np.stack([s.valid for s in batch]),
        }
