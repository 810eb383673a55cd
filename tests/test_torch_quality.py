"""The port's serving-schedule drift harness (``utils/quality.py``)
against the JAX package's.

``drift_metrics`` gives the JAX function's numbers on the same arrays.
``run_schedule`` on the port's tiny quality pipeline (its own seeded
initialisation), at the shape of ``tests/test_pab.py``'s quality budget (8
frames, 128², 25 steps, CFG 8): the exact sampler reproduces itself (drift
0), and ``pab244_deep4_cfg4_ex`` drifts
from it by no more than that test's bound (relative L2 0.098, PSNR ≥ 23.5
dB; 0.0755 and 29.01 dB measured on the CPU) and by more than 1e-4 (a
schedule that stopped reaching the sampler would give the exact video).
``tiny_unet_cfg`` is the JAX one, field for field.
``tests/test_torch_quality_jax.py`` holds ``run_schedule`` to the JAX
harness on one tree.
"""

import dataclasses

import numpy as np
import pytest

from followyourclick_tpu.utils import quality as jquality
from followyourclick_tpu_torch.pipelines.animation import SampleSpec
from followyourclick_tpu_torch.pipelines.serving_schedules import (
    apply_schedule,
)
from followyourclick_tpu_torch.utils import quality
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

F, PX, HL = 8, 128, 16
BASE = dict(video_length=F, height=PX, width=PX, num_inference_steps=25,
            guidance_scale=8.0, use_interpolate_noise=True)


def test_drift_metrics_match_jax():
    rs = np.random.RandomState(0)
    exact = rs.rand(1, 4, 16, 16, 3).astype(np.float32)
    for scale in (0.0, 1e-3, 0.05, 0.5):
        approx = np.clip(exact + scale * rs.randn(*exact.shape), 0, 1) \
            .astype(np.float32)
        assert quality.drift_metrics(approx, exact) \
            == jquality.drift_metrics(approx, exact)


def test_tiny_unet_cfg_matches_jax():
    got, want = quality.tiny_unet_cfg(), jquality.tiny_unet_cfg()
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name
    with pytest.raises(ValueError):
        quality.build_quality_pipeline("medium", device="cpu")


@pytest.fixture(scope="module")
def exact_video():
    pipe = quality.build_quality_pipeline("tiny", seed=0, device="cpu")
    return pipe, quality.run_schedule(pipe, SampleSpec(**BASE), F, (HL, HL))


def test_exact_sampler_reproduces_itself(exact_video):
    pipe, exact = exact_video
    again = quality.run_schedule(pipe, SampleSpec(**BASE), F, (HL, HL))
    assert exact.shape == (1, F, PX, PX, 3) and np.isfinite(exact).all()
    assert quality.drift_metrics(again, exact)["rel_l2"] == 0.0


@pytest.mark.parametrize("name,l2_max,psnr_min", [
    ("pab244_deep4_cfg4_ex", 0.098, 23.5)])
def test_schedule_drift_within_the_quality_budget(exact_video, name, l2_max,
                                                  psnr_min):
    pipe, exact = exact_video
    approx = quality.run_schedule(
        pipe, apply_schedule(SampleSpec(**BASE), name), F, (HL, HL))
    m = quality.drift_metrics(approx, exact)
    assert m["rel_l2"] <= l2_max, m
    assert m["psnr_db"] >= psnr_min, m
    assert m["rel_l2"] > 1e-4, m
