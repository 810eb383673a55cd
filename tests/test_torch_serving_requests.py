"""The port's serving schedules on whole requests: a request of two clips
under ``pab244_deep4_cfg4_ex`` against the JAX ``_sample_jit``, and a
warm-up over every step equal to the exact sampler; the harness, inputs
and tolerances of ``tests/test_torch_serving.py``, whose other tests hold
``denoise`` and the step plans.
"""

import dataclasses

import numpy as np
import torch

from followyourclick_tpu.pipelines import serving_schedules as jss
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.pipelines import serving_schedules as tss
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    SampleSpec,
    step_plan,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_pipeline import EXACT, sample_both
from tests.test_torch_serving import (  # noqa: F401
    CFG,
    HW,
    STEPS,
    F,
    _port_denoise,
    setup,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def test_two_clip_request_matches_jax():
    """A whole request of two different clips (4 frames, 64², CLIP and the
    VAE included) under ``pab244_deep4_cfg4_ex`` at 10 steps, against the
    JAX ``_sample_jit`` at B = 2: the cond-half steps slice the cond clips
    out of the doubled batch (``context[b:]``, the cached halves), with the
    exact path's tolerance. The request's seed is one whose fp32 run is well
    conditioned: at seed 1 the first clip's fp32 video lies 8.6e-3 (port)
    and 4.3e-3 (JAX) from the port's fp64 video, a property of that input
    and not a fault of either side, while at this seed both lie within 8e-5
    of it."""
    got, want = sample_both({**EXACT, "num_inference_steps": STEPS,
                             **jss.SCHEDULES["pab244_deep4_cfg4_ex"]}, b=2,
                            seed=2)
    assert np.abs(got[0] - got[1]).mean() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_warmup_over_every_step_is_the_exact_sampler(setup):
    """pab_warmup_steps ≥ steps: every step is a full recording step with
    no reuse, so the result is the exact sampler's. The serving path feeds
    the UNet the pre-duplicated CFG input where the exact path shares the
    prefix, which changes only the order of fp32 sums, and the first steps
    (t near 1000) amplify that to ~1e-3 at this input; so both run in fp64,
    where they agree to rounding."""
    tree, inputs, _ = setup
    pipe = AnimationPipeline(
        CFG, unet=load_jax_params(UNet3DConditionModel(CFG.unet), tree),
        device="cpu", dtype=torch.float64)
    inputs = {k: v.astype(np.float64) for k, v in inputs.items()}
    exact = SampleSpec(video_length=F, height=8 * HW, width=8 * HW,
                       num_inference_steps=4)
    warm = dataclasses.replace(
        tss.apply_schedule(exact, "pab244_deep4_cfg4_ex"), pab_warmup_steps=4)
    assert all(s.full and not s.mode.reuse_deep for s in step_plan(warm))
    np.testing.assert_allclose(_port_denoise(pipe, inputs, warm),
                               _port_denoise(pipe, inputs, exact), rtol=0,
                               atol=1e-9)
