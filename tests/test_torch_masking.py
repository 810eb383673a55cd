"""The port's mask tools (``followyourclick_tpu_torch/masking/``, no
OpenCV) against the JAX package's (OpenCV), bit for bit.

Each brush function on seeded uint8 images and {0, 255} masks: the
dilation and erosion (odd and even kernels), the crop for filling in its
three regimes (plain crop, upscale of a small image, pad to square and fit
a large mask) and its paste-back, ``resize_and_pad`` / ``recover_size``,
``paste_object`` (with a rescale, near the border). Then ``click_to_masks``
on a tiny ``vit_t`` SAM (shared seeded weights), dilated and not: the same
masks.
"""

import numpy as np
import pytest

from followyourclick_tpu.masking import brush as jbrush
from followyourclick_tpu.masking.click import click_to_masks as jclick
from followyourclick_tpu.sam import SamPredictor as JPredictor
from followyourclick_tpu_torch.masking import brush
from followyourclick_tpu_torch.masking.click import click_to_masks
from followyourclick_tpu_torch.sam import SamPredictor
from tests.test_torch_sam_modules import tiny_sam
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def box_mask(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


def equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            equal(g, w)
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("k", [1, 4, 15])
def test_dilate_and_erode(k):
    rs = np.random.RandomState(k)
    sparse = (rs.rand(60, 70) > 0.98).astype(np.uint8) * 255
    dense = (rs.rand(60, 70) > 0.05).astype(np.uint8) * 255
    equal(brush.dilate_mask(sparse, k), jbrush.dilate_mask(sparse, k))
    equal(brush.erode_mask(dense, k), jbrush.erode_mask(dense, k))
    as_bool = sparse > 0
    equal(brush.dilate_mask(as_bool, k), jbrush.dilate_mask(as_bool, k))


CROPS = {
    "plain crop": ((90, 120), (30, 50, 70, 100)),
    "small image upscaled": ((40, 56), (10, 20, 12, 30)),
    "large mask pad and fit": ((90, 120), (5, 85, 10, 115)),
    "tall image, large mask": ((130, 70), (4, 120, 2, 66)),
}


@pytest.mark.parametrize("case", list(CROPS))
def test_crop_for_filling(case):
    (h, w), box = CROPS[case]
    img, mask = image(1, h, w), box_mask(h, w, *box)
    crop = 64
    got = brush.crop_for_filling_pre(img, mask, crop)
    equal(got, jbrush.crop_for_filling_pre(img, mask, crop))
    filled = image(2, crop, crop)
    before = img.copy()
    out = brush.crop_for_filling_post(img, mask, filled, crop)
    equal(out, jbrush.crop_for_filling_post(img, mask, filled, crop))
    assert np.array_equal(img, before)  # the caller's array untouched
    assert np.array_equal(out[mask == 0], img[mask == 0])


@pytest.mark.parametrize("shape,target", [((90, 120), 64), ((130, 70), 96),
                                          ((50, 50), 80)])
def test_resize_and_pad_and_recover(shape, target):
    img, mask = image(3, *shape), box_mask(*shape, 10, 40, 20, 45)
    got = brush.resize_and_pad(img, mask, target)
    want = jbrush.resize_and_pad(img, mask, target)
    equal(got, want)
    out = image(4, target, target)
    equal(brush.recover_size(out, got[1], shape, got[2]),
          jbrush.recover_size(out, want[1], shape, want[2]))


@pytest.mark.parametrize("coords,scale", [((40, 30), 1.0), ((5, 4), 1.0),
                                          ((70, 55), 0.7), ((3, 60), 1.6)])
def test_paste_object(coords, scale):
    src, target = image(5, 60, 80), image(6, 64, 76)
    mask = box_mask(60, 80, 12, 40, 20, 50)
    mask[20:25, 30:35] = 0
    equal(brush.paste_object(src, mask, target, coords, scale),
          jbrush.paste_object(src, mask, target, coords, scale))


@pytest.fixture(scope="module")
def predictors():
    model, jmodel, variables = tiny_sam(seed=1)
    return SamPredictor(model, "cpu"), JPredictor(jmodel, variables)


@pytest.mark.parametrize("dilate", [None, 5])
def test_click_to_masks(predictors, dilate):
    port, jax_pred = predictors
    img = image(7, 88, 120)
    got = click_to_masks(img, (50, 40), port, dilate_kernel_size=dilate)
    want = jclick(img, (50, 40), jax_pred, dilate_kernel_size=dilate)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        equal(g, w)
