"""The port's ``SamPredictor``, mask postprocessing, ``ResizeLongestSide``
and automatic mask generator against the JAX package's, fp32 on the CPU.

One tiny ``vit_t`` SAM on shared seeded weights (``tests/
test_torch_sam_modules.tiny_sam``). Tolerances: mask logits 1e-4 of their
largest magnitude; boolean masks equal wherever |logit| > 1e-3 (a pixel
closer to the threshold may fall either side); IoU 1e-5. The image resize
is OpenCV's uint8 bilinear bit for bit (no residual), held to ``cv2``
itself. The automatic mask generator runs at 8 points a side with both
quality thresholds at 0 (random weights keep nothing at the defaults): the
same records, the same boxes, IoU and stability 1e-5.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.sam import SamAutomaticMaskGenerator as JAMG
from followyourclick_tpu.sam import SamPredictor as JPredictor
from followyourclick_tpu.sam import amg as jamg
from followyourclick_tpu.sam.sam import postprocess_masks as jpostprocess
from followyourclick_tpu_torch.sam import (
    SamAutomaticMaskGenerator,
    SamPredictor,
)
from followyourclick_tpu_torch.sam import amg
from followyourclick_tpu_torch.sam.predictor import ResizeLongestSide
from followyourclick_tpu_torch.sam.sam import postprocess_masks
from tests.test_torch_sam_modules import tiny_sam
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
IOU_TOL = 1e-5
NEAR_THRESHOLD = 1e-3


@pytest.fixture(scope="module")
def predictors():
    model, jmodel, variables = tiny_sam()
    return SamPredictor(model, "cpu"), JPredictor(jmodel, variables)


def image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def check_logits(got, want):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= LOGIT_TOL * scale


def check_masks(got, want, logits):
    assert got.dtype == want.dtype == bool and got.shape == want.shape
    sure = np.abs(logits) > NEAR_THRESHOLD
    assert np.array_equal(got[sure], want[sure])


PREDICT = {
    "point": dict(point_coords=np.array([[40.0, 50.0]]),
                  point_labels=np.array([1])),
    "two points": dict(point_coords=np.array([[10.0, 12.0], [50.0, 30.0]]),
                       point_labels=np.array([1, 0])),
    "point+box single": dict(point_coords=np.array([[10.0, 10.0]]),
                             point_labels=np.array([1]),
                             box=np.array([5.0, 5.0, 40.0, 40.0]),
                             multimask_output=False),
    "box": dict(box=np.array([8.0, 4.0, 60.0, 50.0])),
    "point+mask": dict(point_coords=np.array([[30.0, 20.0]]),
                       point_labels=np.array([1]), mask_input="low_res"),
}


@pytest.mark.parametrize("shape", [(96, 80), (64, 64)])
@pytest.mark.parametrize("case", list(PREDICT))
def test_predict(predictors, shape, case):
    port, jax_pred = predictors
    img = image(sum(shape), *shape)
    port.set_image(img)
    jax_pred.set_image(img)
    np.testing.assert_allclose(
        port.get_image_embedding().permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_pred.get_image_embedding()), rtol=0,
        atol=1e-5 * float(np.abs(jax_pred.get_image_embedding()).max()))
    kw = dict(PREDICT[case])
    if kw.get("mask_input") == "low_res":
        kw["mask_input"] = np.random.RandomState(5).randn(32, 32).astype(
            np.float32)
    logits, iou, low = port.predict(**kw, return_logits=True)
    want_logits, want_iou, want_low = jax_pred.predict(**kw,
                                                       return_logits=True)
    k = 1 if kw.get("multimask_output") is False else 3
    assert logits.shape == (k,) + shape and low.shape == (k, 32, 32)
    check_logits(logits, want_logits)
    check_logits(low, want_low)
    np.testing.assert_allclose(iou, want_iou, rtol=0, atol=IOU_TOL)
    masks, _, _ = port.predict(**kw)
    want_masks, _, _ = jax_pred.predict(**kw)
    check_masks(masks, want_masks, want_logits)


def test_predict_batch(predictors):
    port, jax_pred = predictors
    img = image(7, 80, 112)
    port.set_image(img)
    jax_pred.set_image(img)
    pts = np.random.RandomState(8).uniform(0, 80, (5, 2, 2)).astype(
        np.float32)
    labels = np.array([[1, 1], [1, 0], [0, 1], [1, 1], [1, 0]], np.int32)
    for multimask in (True, False):
        logits, iou = port.predict_batch(pts, labels, multimask, True)
        want_logits, want_iou = jax_pred.predict_batch(pts, labels,
                                                       multimask, True)
        assert logits.shape == (5, 3 if multimask else 1, 80, 112)
        check_logits(logits, want_logits)
        np.testing.assert_allclose(iou, want_iou, rtol=0, atol=IOU_TOL)
        masks, _ = port.predict_batch(pts, labels, multimask)
        want_masks, _ = jax_pred.predict_batch(pts, labels, multimask)
        check_masks(masks, want_masks, want_logits)


def test_embedding_cached_on_the_device(predictors):
    port, _ = predictors
    port.set_image(image(9, 64, 64))
    emb = port.get_image_embedding()
    port.predict(point_coords=np.array([[1.0, 1.0]]),
                 point_labels=np.array([1]))
    assert port.get_image_embedding() is emb
    assert emb.device == port.device


@pytest.mark.parametrize("sizes", [
    ((32, 32), (128, 107), (96, 80)),    # the crop, then a shrink
    ((32, 32), (128, 128), (300, 300)),  # an enlargement
    ((32, 32), (90, 128), (45, 64)),     # a shrink by 2
    ((32, 32), (128, 77), (200, 121)),
])
def test_postprocess_masks_matches_jax_image_resize(sizes):
    low, input_size, original = sizes
    x = np.random.RandomState(10).randn(2, 3, *low).astype(np.float32)
    want = jpostprocess(jnp.asarray(x), input_size, original, 128)
    got = postprocess_masks(torch.from_numpy(x), input_size, original, 128)
    assert tuple(got.shape) == (2, 3) + original
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(96, 80), (64, 64), (700, 500), (37, 53),
                                   (128, 128), (5, 300)])
def test_resize_longest_side_matches_cv2(shape):
    """OpenCV's uint8 bilinear, bit for bit, and the coordinate maps."""
    t = ResizeLongestSide(128)
    img = image(11, *shape)
    target = t.get_preprocess_shape(*shape, 128)
    want = cv2.resize(img, (target[1], target[0]),
                      interpolation=cv2.INTER_LINEAR)
    got = t.apply_image(img)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    coords = np.array([[3.0, 7.0], [shape[1] - 1.0, shape[0] - 1.0]])
    from followyourclick_tpu.sam.predictor import ResizeLongestSide as JRLS

    jt = JRLS(128)
    np.testing.assert_array_equal(t.apply_coords(coords, shape),
                                  jt.apply_coords(coords, shape))
    box = np.array([1.0, 2.0, 30.0, 40.0])
    np.testing.assert_array_equal(t.apply_boxes(box, shape),
                                  jt.apply_boxes(box, shape))


def test_amg_helpers_match_jax():
    rs = np.random.RandomState(12)
    np.testing.assert_array_equal(amg.build_point_grid(5),
                                  jamg.build_point_grid(5))
    logits = rs.randn(4, 3, 20, 24).astype(np.float32) * 2
    np.testing.assert_allclose(
        amg.calculate_stability_score(torch.from_numpy(logits), 0.0,
                                      1.0).numpy(),
        jamg.calculate_stability_score(logits, 0.0, 1.0), rtol=0,
        atol=1e-12)
    masks = rs.rand(6, 20, 24) > 0.97
    masks[2] = False
    np.testing.assert_array_equal(
        amg.batched_mask_to_box(torch.from_numpy(masks)).numpy(),
        jamg.batched_mask_to_box(masks))
    boxes = np.sort(rs.uniform(0, 50, (30, 2, 2)), axis=1).transpose(
        0, 2, 1).reshape(30, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    scores = rs.rand(30).astype(np.float32)
    for thresh in (0.1, 0.5, 0.7):
        np.testing.assert_array_equal(
            amg.box_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        thresh),
            jamg.box_nms(boxes, scores, thresh))


def test_automatic_mask_generator(predictors):
    port, jax_pred = predictors
    img = image(13, 72, 96)
    kw = dict(points_per_side=8, points_per_batch=16, pred_iou_thresh=0.0,
              stability_score_thresh=0.0)
    got = SamAutomaticMaskGenerator(port, **kw).generate(img)
    want = JAMG(jax_pred, **kw).generate(img)
    assert len(got) == len(want) > 0
    for r, w in zip(got, want):
        assert r["point_coords"] == w["point_coords"]
        assert r["bbox"] == w["bbox"] and r["area"] == w["area"]
        np.testing.assert_array_equal(r["segmentation"], w["segmentation"])
        assert abs(r["predicted_iou"] - w["predicted_iou"]) <= IOU_TOL
        assert abs(r["stability_score"] - w["stability_score"]) <= IOU_TOL
    # at the default thresholds: the same records (random weights keep
    # few or none)
    got = SamAutomaticMaskGenerator(port, points_per_side=4).generate(img)
    want = JAMG(jax_pred, points_per_side=4).generate(img)
    assert [r["bbox"] for r in got] == [w["bbox"] for w in want]
