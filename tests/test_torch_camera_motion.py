"""The port's camera-motion augmentation against the JAX package's, which
warps with OpenCV (5.0 here).

OpenCV's ``warpAffine`` (INTER_LINEAR) samples in float32; the port
rounds its steps as OpenCV does (``data/camera_motion.py``), and a rare
byte still differs by 1: every clip and warp here must agree within
``MAX_DIFF`` with at most ``DIFF_SHARE`` of the bytes off (measured: at
most 3 bytes in 98304 a clip, 3e-5). The rotation matrix is OpenCV's to
the last bit; the motion types and the seeded draws of a type are the
JAX class's.
"""

import cv2
import numpy as np
import pytest
import torch

from followyourclick_tpu.data import camera_motion as jcam
from followyourclick_tpu_torch.data import camera_motion as cam
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

MAX_DIFF = 1
DIFF_SHARE = 1e-4


def image(seed, h=120, w=160):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def assert_close_uint8(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= MAX_DIFF
    assert (diff > 0).mean() <= DIFF_SHARE


def test_motion_types():
    assert cam.MOTION_TYPES == jcam.MOTION_TYPES


@pytest.mark.parametrize("motion", jcam.MOTION_TYPES)
def test_every_motion_type_matches_jax(motion):
    img = image(0)
    want, jidx = jcam.CameraMotionAugmentation(8, 64)(img, motion)
    got, idx = cam.CameraMotionAugmentation(8, 64, device="cpu")(img,
                                                                 motion)
    assert idx == jidx == jcam.MOTION_TYPES.index(motion)
    assert got.shape == (8, 64, 64, 3)
    assert_close_uint8(got, want)
    # the clip moves: its first and last frames differ
    assert np.abs(got[0].astype(int) - got[-1]).mean() > 1


def test_seeded_types_are_the_jax_draws():
    img = image(1, 90, 100)
    j = jcam.CameraMotionAugmentation(3, 32, seed=7)
    p = cam.CameraMotionAugmentation(3, 32, seed=7, device="cpu")
    for _ in range(6):
        want, jidx = j(img)
        got, idx = p(img)
        assert idx == jidx
        assert_close_uint8(got, want)
    with pytest.raises(ValueError):
        p(img, "dolly_zoom")


def test_synthesize_camera_clip():
    img = image(2, 100, 80)
    want = jcam.synthesize_camera_clip(img, "zoom_in", 4, 48)
    got = cam.synthesize_camera_clip(img, "zoom_in", 4, 48, device="cpu")
    assert_close_uint8(got, want)


@pytest.mark.parametrize("center,angle,scale", [
    ((80.0, 60.0), 0.0, 0.6667), ((70.3, 40.1), 7.5, 1.3),
    ((12.25, 99.9), -12.0, 0.41), ((0.1, 0.7), 180.0, 2.0)])
def test_rotation_matrix_is_opencvs(center, angle, scale):
    np.testing.assert_array_equal(
        cam.rotation_matrix_2d(center, angle, scale),
        cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_matches_opencv(seed):
    """Random affine maps that reach outside the image (the constant-0
    border) and shrink, grow, shear and rotate it."""
    rs = np.random.RandomState(seed)
    img = image(10 + seed, 70, 90)
    m = np.array([[rs.uniform(0.5, 1.5), rs.uniform(-0.4, 0.4),
                   rs.uniform(-20, 20)],
                  [rs.uniform(-0.4, 0.4), rs.uniform(0.5, 1.5),
                   rs.uniform(-20, 20)]])
    want = cv2.warpAffine(img, m, (80, 60), flags=cv2.INTER_LINEAR)
    got = cam.warp_affine(torch.from_numpy(img), m, (80, 60)).numpy()
    assert (want == 0).all(axis=-1).any()  # the border is reached
    assert_close_uint8(got, want)
