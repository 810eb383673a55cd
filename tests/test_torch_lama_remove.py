"""LaMa removal on the click: ``inpaint.remove_anything``, the app's
``ClickSession`` and ``build_app``, the port against the JAX package, fp32
on the CPU.

Weights are shared: a tiny ``vit_t`` SAM (``tests/test_torch_sam_modules``)
and the tiny LaMa of ``tests/test_torch_lama.py`` (seeded, converted to
flax by the JAX converter). Checked:

- ``remove_anything``: the same three dilated masks (equal) and scores
  (1e-5) as JAX's, each removal within 1 of the JAX one in uint8 and equal
  to the input outside its mask;
- ``ClickSession`` without gradio: ``upload`` encodes once, ``click`` gives
  the masks of ``remove_anything`` and the red overlays of the JAX app's
  formula (``0.5·pixel + [127, 0, 0]``, truncated), ``remove`` the same
  removals as ``remove_anything``;
- ``build_app`` raises an ``ImportError`` naming gradio where gradio is not
  installed, and ``cli.app.main`` gets as far as that on the CPU.
"""

import sys

import numpy as np
import pytest
import torch

from followyourclick_tpu.inpaint import lama as jlama
from followyourclick_tpu.inpaint import remove as jremove
from followyourclick_tpu.sam import SamPredictor as JPredictor
from followyourclick_tpu_torch.cli import app
from followyourclick_tpu_torch.inpaint import lama, remove
from followyourclick_tpu_torch.sam import SamPredictor
from tests.test_torch_lama import jax_vars, port_model, tiny
from tests.test_torch_sam_modules import tiny_sam
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

POINT = (50, 30)
DILATE = 9


@pytest.fixture(scope="module")
def setup():
    model, jmodel, jvars = tiny_sam(seed=4)
    cfg, jcfg = tiny()
    gen = port_model(cfg, seed=2)
    img = (np.random.RandomState(9).rand(60, 84, 3) * 255).astype(np.uint8)
    return dict(
        img=img, predictor=SamPredictor(model, "cpu"),
        jpredictor=JPredictor(jmodel, jvars),
        inpainter=lama.LamaInpainter(gen, "cpu"),
        jinpainter=jlama.LamaInpainter(jlama.FFCResNetGenerator(jcfg),
                                       jax_vars(gen, jcfg)))


@pytest.fixture(scope="module")
def removed(setup):
    s = setup
    got = remove.remove_anything(s["img"], POINT, s["predictor"],
                                 s["inpainter"], dilate_kernel_size=DILATE)
    want = jremove.remove_anything(s["img"], POINT, s["jpredictor"],
                                   s["jinpainter"], dilate_kernel_size=DILATE)
    return got, want


def test_remove_anything(setup, removed):
    got, want = removed
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g["mask"], w["mask"])
        assert abs(g["score"] - w["score"]) <= 1e-5
        out = g["inpainted"]
        assert out.dtype == np.uint8 and out.shape == setup["img"].shape
        assert np.abs(out.astype(int) - w["inpainted"]).max() <= 1
        keep = g["mask"] == 0
        assert np.array_equal(out[keep], setup["img"][keep])


def test_click_session(setup, removed):
    s = setup
    session = app.ClickSession(s["predictor"], s["inpainter"], DILATE)
    calls = []
    real = s["predictor"].set_image
    s["predictor"].set_image = lambda img: calls.append(1) or real(img)
    try:
        assert "click" in session.upload(s["img"])
        overlays = session.click(*POINT)
        overlays_again = session.click(*POINT)
    finally:
        del s["predictor"].set_image
    assert len(calls) == 1  # the image is encoded once, not per click
    got, _ = removed
    assert len(overlays) == len(session.masks) == 3
    for o, again, m, r in zip(overlays, overlays_again, session.masks, got):
        assert np.array_equal(m, r["mask"])
        want = s["img"].copy()
        want[m > 0] = (0.5 * want[m > 0] + [127, 0, 0]).astype(np.uint8)
        assert o.dtype == np.uint8 and np.array_equal(o, want)
        assert np.array_equal(o, again)
    for out, r in zip(session.remove(), got):
        assert np.array_equal(out, r["inpainted"])


def test_build_app_without_gradio(setup, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        app.build_app(setup["predictor"], setup["inpainter"])


def test_app_main_without_gradio(monkeypatch, tmp_path):
    """The flags build the SAM of a checkpoint and big-LaMa, then the app."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    built = {}
    real = app.build_app

    def spy(predictor, inpainter, dilate_kernel_size=15):
        built.update(predictor=predictor, inpainter=inpainter)
        return real(predictor, inpainter, dilate_kernel_size)

    monkeypatch.setattr(app, "build_app", spy)
    model, _, _ = tiny_sam(seed=1)
    torch.save(model.state_dict(), tmp_path / "sam.pth")
    with pytest.raises(ImportError, match="gradio"):
        app.main(["--sam_ckpt", str(tmp_path / "sam.pth"), "--sam_model_type",
                  "vit_t", "--device", "cpu"])
    assert isinstance(built["predictor"], SamPredictor)
    assert built["inpainter"].model.config == lama.LamaConfig()


class _Event:
    """``torch.cuda.Event`` on the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_smoke_phases_rehearse_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke`` phases 18-19 at a tiny LaMa, a ``vit_t`` SAM and
    small images on the CPU (the card's events, memory statistics and
    profiler stubbed): every check they make on the card passes."""
    import chip_smoke

    for name, fn in (("Event", _Event), ("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(chip_smoke, "profiled", lambda acts, fn: (
        fn(), 1.0, 0.0, [], [(0.0, 1e5, "fft_r2c")], 0.5)[1:])
    cfg = lama.LamaConfig(ngf=8, n_downsampling=2, n_blocks=2)
    got = chip_smoke.phase_remove(0, str(tmp_path), device="cpu",
                                  sam_type="vit_t", image_size=(72, 96),
                                  config=cfg, sizes=((64, 96), (32, 32)),
                                  cpu_size=32)
    assert not any(got.values())
    got = chip_smoke.phase_lama_train(0, device="cpu", config=cfg, size=64,
                                      batch=2, steps=2,
                                      pl_layers=(1, 1, 1, 1))
    assert not any(got.values())
