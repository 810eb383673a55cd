"""The port's ``utils/video_io.py`` against the JAX package's.

- ``downsample_mask_to_latent``: the port's ``F.interpolate`` (bilinear,
  half-pixel centres, no antialias) against the JAX ``cv2.resize
  (INTER_LINEAR)`` on binary and soft masks, 1e-6 at the CLI's factor of 8
  (H and W to H/8 and W/8); at a non-integer factor 1e-5, since the two
  round the source coordinate's weights apart (cv2 in double, torch in
  float: 4.6e-6 seen on values in [0, 1]).
- The crops (``load_image_and_mask`` with "crop" and "resize_and_crop")
  and the CLIP preprocessing (PIL image, [-1, 1] float, uint8): exact, as
  both call the same PIL operations.
- GIF grids of full-colour frames (random values, so each frame is
  quantized to a 256-colour palette): the port's PIL writer and the JAX
  ``imageio.mimsave`` write the same bytes, and the frames read back
  equal; the port's writer needs no imageio.
- ``slerp``: equal.
"""

import builtins
import os

import numpy as np
import pytest

from followyourclick_tpu.utils import video_io as jvio
from followyourclick_tpu_torch.utils import video_io as tvio
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("hw,latent,soft,atol", [
    ((512, 512), (64, 64), False, 1e-6), ((256, 448), (32, 56), True, 1e-6),
    ((100, 60), (13, 7), True, 1e-5)], ids=["512_binary", "256x448_soft",
                                            "odd_soft"])
def test_mask_downsample_matches_cv2(hw, latent, soft, atol):
    rs = np.random.RandomState(hw[0])
    mask = rs.rand(*hw, 1).astype(np.float32)
    if not soft:
        mask = (mask > 0.7).astype(np.float32)
    got = tvio.downsample_mask_to_latent(mask, *latent)
    want = jvio.downsample_mask_to_latent(mask, *latent)
    assert got.shape == want.shape == latent + (1,)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("img")
    rs = np.random.RandomState(1)
    img = (rs.rand(90, 150, 3) * 255).astype(np.uint8)
    mask = ((rs.rand(90, 150) > 0.5) * 255).astype(np.uint8)
    Image.fromarray(img).save(d / "img.png")
    Image.fromarray(mask).save(d / "mask.png")
    return str(d / "img.png"), str(d / "mask.png")


@pytest.mark.parametrize("crop", ["crop", "resize_and_crop"])
def test_image_and_mask_crop_match(image_files, crop):
    img, mask = image_files
    got = tvio.load_image_and_mask(img, mask, 64, 96, crop_method=crop)
    want = jvio.load_image_and_mask(img, mask, 64, 96, crop_method=crop)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (64, 96, 3) and got[1].shape == (64, 96, 1)
    with pytest.raises(ValueError):
        tvio.load_image_and_mask(img, None, 64, 96, crop_method="squash")


@pytest.mark.parametrize("kind", ["pil", "float_pm1", "uint8"])
def test_clip_preprocess_matches(image_files, kind):
    from PIL import Image

    img = Image.open(image_files[0])
    arr = np.asarray(img)
    src = {"pil": img, "float_pm1": arr.astype(np.float32) / 127.5 - 1.0,
           "uint8": arr}[kind]
    got = tvio.clip_preprocess_image(src)
    want = jvio.clip_preprocess_image(src)
    assert got.shape == want.shape == (1, 224, 224, 3)
    np.testing.assert_array_equal(got, want)


def _read_gif(path):
    import imageio

    return [np.asarray(f)[..., :3] for f in imageio.mimread(path)]


def _write_both(tmp_path, videos, **kw):
    tvio.save_videos_grid(videos, str(tmp_path / "port" / "g.gif"), **kw)
    jvio.save_videos_grid(videos, str(tmp_path / "jax" / "g.gif"), **kw)
    return str(tmp_path / "port" / "g.gif"), str(tmp_path / "jax" / "g.gif")


def test_gif_grids_read_back_equal(tmp_path):
    rs = np.random.RandomState(2)
    videos = rs.rand(3, 4, 16, 24, 3).astype(np.float32)
    port, jax_gif = _write_both(tmp_path, videos, n_rows=2)
    with open(port, "rb") as a, open(jax_gif, "rb") as b:
        assert a.read() == b.read()
    got, want = _read_gif(port), _read_gif(jax_gif)
    assert len(got) == len(want) == 4 and got[0].shape == (32, 48, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pil_gif_writer_without_imageio(tmp_path, monkeypatch):
    """With imageio not installed the port still writes the GIF (PIL
    alone), byte for byte the JAX writer's, here on full-colour 64²
    clips in [-1, 1], rescaled."""
    rs = np.random.RandomState(3)
    videos = rs.rand(2, 3, 64, 64, 3).astype(np.float32) * 2 - 1
    jvio.save_videos_grid(videos, str(tmp_path / "jax.gif"), rescale=True)
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name == "imageio":
            raise ImportError("no imageio")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    tvio.save_videos_grid(videos, str(tmp_path / "pil.gif"), rescale=True)
    monkeypatch.undo()
    with open(tmp_path / "pil.gif", "rb") as a, \
            open(tmp_path / "jax.gif", "rb") as b:
        assert a.read() == b.read()
    got = _read_gif(str(tmp_path / "pil.gif"))
    want = tvio.videos_grid_frames(videos, rescale=True)
    assert len(got) == 3 and got[0].shape == (128, 64, 3)
    # a 256-colour palette over random colours: near the grid on average
    err = np.mean([np.abs(g.astype(int) - w).mean()
                   for g, w in zip(got, want)])
    assert 0 < err <= 16, err


def test_slerp_matches():
    rs = np.random.RandomState(4)
    a, b = rs.randn(2, 4, 8, 8)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(tvio.slerp(t, a, b),
                                      jvio.slerp(t, a, b))
    np.testing.assert_array_equal(tvio.slerp(0.4, a, a * 2),
                                  jvio.slerp(0.4, a, a * 2))
