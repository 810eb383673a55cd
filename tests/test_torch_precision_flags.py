"""Every entry point of the port runs under the numerics it was checked
under (``utils/backend_flags.checked_precision``: matmul TF32, cuDNN TF32
and bf16 reduced-precision reduction off) and gives the caller's flags
back.

Each case calls one entry point with the first thing it computes stubbed
by a recorder, which notes the three flags and raises: the recorded flags
must be all off, whatever the caller had set, and the caller's must be
back after the entry point leaves by that exception. The cases: the CLI
mains (``inference``, ``animate``, ``click_mask``, ``inpaint``, ``app``,
``flow_tools``), ``train_loop``, the LaMa generator and discriminator
steps, ``sample`` / ``__call__`` of the three pipelines, ``SamPredictor``
(``set_image`` and its predicts), ``LamaInpainter``, and the flow API and
trainer.
"""

import types

import numpy as np
import pytest
import torch
from torch import nn

from followyourclick_tpu_torch.utils.backend_flags import (
    checked_precision,
    precision_flags,
)

OFF = (False, False, False)


class Seen(Exception):
    """Raised by a recorder after it noted the flags."""


class Recorder:
    def __init__(self):
        self.flags = []

    def __call__(self, *args, **kwargs):
        self.flags.append(precision_flags())
        raise Seen


class RecordingModule(nn.Module):
    """A module whose forward records; one parameter, for the callers that
    read the device and dtype from it."""

    def __init__(self, rec, **attrs):
        super().__init__()
        self.rec = rec
        self.weight = nn.Parameter(torch.zeros(1))
        for k, v in attrs.items():
            setattr(self, k, v)

    def forward(self, *args, **kwargs):
        return self.rec(*args, **kwargs)


@pytest.fixture
def caller_flags():
    """The process's flags set to a mixed pattern the entry point must give
    back; restored after the test."""
    from followyourclick_tpu_torch.utils import backend_flags

    saved = precision_flags()
    pattern = (True, False, True)
    backend_flags._set(pattern)
    yield pattern
    backend_flags._set(saved)


def _tiny_pipeline():
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )
    from tests.test_torch_unet import TINY_CLIP, TINY_UNET, TINY_VAE
    from followyourclick_tpu_torch.config import InferenceConfig

    return AnimationPipeline(InferenceConfig(unet=TINY_UNET, vae=TINY_VAE,
                                             clip_text=TINY_CLIP),
                             device="cpu")


def _cli(module, argv, patch_target, name):
    def run(rec, monkeypatch):
        import importlib

        monkeypatch.setattr(importlib.import_module(patch_target), name, rec)
        importlib.import_module(module).main(argv)
    return run


def _animation(method):
    def run(rec, monkeypatch):
        pipe = _tiny_pipeline()
        ids = torch.zeros(1, 77, dtype=torch.long)
        if method == "sample":
            monkeypatch.setattr(pipe, "encode_prompt", rec)
            pipe.sample(ids, ids, None, None, None, None)
        else:
            monkeypatch.setattr(pipe, "tokenize", rec)
            pipe("a cat")
    return run


def _image_pipeline(kind, method):
    def run(rec, monkeypatch):
        from followyourclick_tpu_torch.pipelines.inpaint import (
            InpaintPipeline,
        )
        from followyourclick_tpu_torch.pipelines.text_to_image import (
            TextToImagePipeline,
        )

        video = _tiny_pipeline()
        args = (video.config, video.unet, video.vae, video.text_encoder, rec)
        pipe = (TextToImagePipeline(*args) if kind == "t2i" else
                InpaintPipeline(*args, device="cpu"))
        monkeypatch.setattr(pipe.text_encoder, "forward", rec)
        ids = torch.zeros(1, 77, dtype=torch.long)
        if method == "sample" and kind == "t2i":
            pipe.sample(ids, ids, 64, 64, 1)
        elif method == "sample":
            pipe.sample(torch.zeros(1, 64, 64, 3), torch.zeros(1, 8, 8, 1),
                        ids, ids, 1)
        elif kind == "t2i":
            pipe("a cat")
        else:
            pipe(np.zeros((64, 64, 3), np.float32),
                 np.zeros((8, 8, 1), np.float32), "a cat")
    return run


def _predictor(method):
    def run(rec, monkeypatch):
        from followyourclick_tpu_torch.sam.predictor import (
            ResizeLongestSide,
            SamPredictor,
        )

        p = SamPredictor.__new__(SamPredictor)
        p.model = types.SimpleNamespace(
            encode_image=rec, preprocess=lambda x: x,
            predict_from_embedding=rec,
            config=types.SimpleNamespace(img_size=64))
        p.device, p.dtype = torch.device("cpu"), torch.float32
        p.transform = ResizeLongestSide(64)
        p.is_image_set, p.features = True, torch.zeros(1, 4, 4, 4)
        p.original_size, p.input_size = (32, 32), (64, 64)
        point = np.array([[3.0, 4.0]])
        if method == "set_image":
            p.set_image(np.zeros((32, 32, 3), np.uint8))
        elif method == "predict":
            p.predict(point, np.array([1]))
        elif method == "predict_torch":
            p.predict_torch(point[None], np.array([[1]]))
        else:
            p.predict_batch(point[None], np.array([[1]]))
    return run


def _lama(rec, monkeypatch):
    from followyourclick_tpu_torch.inpaint.lama import LamaInpainter

    model = RecordingModule(rec, config=types.SimpleNamespace(
        dtype=torch.float32))
    LamaInpainter(model, "cpu")(np.zeros((8, 8, 3), np.uint8),
                                np.zeros((8, 8), np.uint8))


def _lama_step(which):
    def run(rec, monkeypatch):
        from followyourclick_tpu_torch.inpaint import train

        gen, disc = RecordingModule(rec), RecordingModule(rec)
        cfg = train.LamaTrainConfig()
        batch = {"image": torch.zeros(1, 3, 8, 8),
                 "mask": torch.zeros(1, 1, 8, 8)}
        opt = torch.optim.Adam(gen.parameters())
        if which == "generator":
            train.generator_step(gen, disc, cfg, opt, batch)
        else:
            train.discriminator_step(disc, cfg, opt, batch,
                                     torch.zeros(1, 3, 8, 8))
    return run


def _train_loop(rec, monkeypatch):
    import tempfile

    from followyourclick_tpu_torch.training.loop import LoopConfig, train_loop

    state = types.SimpleNamespace(params={"w": torch.zeros(1)})
    with tempfile.TemporaryDirectory() as out:
        train_loop(state, iter([{}]), rec,
                   LoopConfig(output_dir=out, max_train_steps=1,
                              temporal_multi_scale=False))


def _flow(which):
    def run(rec, monkeypatch):
        from followyourclick_tpu_torch.flow import api, train

        model = RecordingModule(rec)
        frames = np.zeros((2, 16, 16, 3), np.uint8)
        if which == "inference_model":
            api.inference_model(model, frames[0], frames[1])
        elif which == "compute_motion_score":
            api.compute_motion_score(model, frames)
        else:
            cfg = train.FlowTrainConfig()
            tx = train.FlowOptimizer(cfg)
            batch = {"img1": np.zeros((1, 16, 16, 3), np.float32),
                     "img2": np.zeros((1, 16, 16, 3), np.float32),
                     "flow_gt": np.zeros((1, 16, 16, 2), np.float32)}
            if which == "train_step":
                train.train_step(model, cfg, tx, tx.init(
                    dict(model.named_parameters())), batch)
            else:
                train.train_model(model, iter([batch]), cfg,
                                  work_dir="unused", resume=False)
    return run


CASES = {
    "cli.inference": _cli(
        "followyourclick_tpu_torch.cli.inference",
        ["--config", "c.yaml", "--file", "p.csv"],
        "followyourclick_tpu_torch.parallel.mesh", "initialize_distributed"),
    "cli.animate": _cli(
        "followyourclick_tpu_torch.cli.animate", ["--config", "c.yaml"],
        "followyourclick_tpu_torch.cli.animate", "build_parser"),
    "cli.click_mask": _cli(
        "followyourclick_tpu_torch.cli.click_mask",
        ["--input_img", "x.png", "--point_coords", "1", "2", "--output_dir",
         "out"], "followyourclick_tpu_torch.cli.click_mask",
        "build_predictor"),
    "cli.inpaint": _cli(
        "followyourclick_tpu_torch.cli.inpaint",
        ["remove", "--input_img", "x.png", "--point_coords", "1", "2",
         "--output_dir", "out"], "followyourclick_tpu_torch.cli.inpaint",
        "read_rgb"),
    "cli.app": _cli(
        "followyourclick_tpu_torch.cli.app", ["--sam_ckpt", "s.pth"],
        "followyourclick_tpu_torch.cli.click_mask", "build_predictor"),
    "cli.flow_tools": _cli(
        "followyourclick_tpu_torch.cli.flow_tools",
        ["flops", "--config", "c.yaml"],
        "followyourclick_tpu_torch.cli.flow_tools", "_flops"),
    "train_loop": _train_loop,
    "lama.generator_step": _lama_step("generator"),
    "lama.discriminator_step": _lama_step("discriminator"),
    "AnimationPipeline.sample": _animation("sample"),
    "AnimationPipeline.__call__": _animation("__call__"),
    "TextToImagePipeline.sample": _image_pipeline("t2i", "sample"),
    "TextToImagePipeline.__call__": _image_pipeline("t2i", "__call__"),
    "InpaintPipeline.sample": _image_pipeline("inpaint", "sample"),
    "InpaintPipeline.__call__": _image_pipeline("inpaint", "__call__"),
    "SamPredictor.set_image": _predictor("set_image"),
    "SamPredictor.predict": _predictor("predict"),
    "SamPredictor.predict_torch": _predictor("predict_torch"),
    "SamPredictor.predict_batch": _predictor("predict_batch"),
    "LamaInpainter.__call__": _lama,
    "flow.inference_model": _flow("inference_model"),
    "flow.compute_motion_score": _flow("compute_motion_score"),
    "flow.train_step": _flow("train_step"),
    "flow.train_model": _flow("train_model"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_point_runs_under_the_contract(name, caller_flags,
                                            monkeypatch):
    rec = Recorder()
    with pytest.raises(Seen):
        CASES[name](rec, monkeypatch)
    assert rec.flags and set(rec.flags) == {OFF}, rec.flags
    assert precision_flags() == caller_flags


def test_checked_precision_restores_on_return_and_nests(caller_flags):
    with checked_precision():
        assert precision_flags() == OFF
        with checked_precision():
            assert precision_flags() == OFF
        assert precision_flags() == OFF
    assert precision_flags() == caller_flags
