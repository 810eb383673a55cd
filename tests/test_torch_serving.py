"""The port's serving schedules against the JAX sampler's.

``AnimationPipeline.denoise`` of the port and of the JAX package run the
same tiny request (2 frames, 64², CFG 8; the tiny UNet of
tests/test_torch_unet.py with the same random parameters, by
``load_jax_params``) from the same initial latents, fp32 on the CPU, under a
composed schedule that reaches every step class: ``pab244_deep4_cfg4_ex`` at
10 steps is two periods of 4 (full record steps, cond-half steps with
attention and trunk reuse, a full step reusing temporal and cross
attention) and 2 final exact steps; ``cfg_cache3`` at 10 steps is the plain
CFG-uncond cache. The final latents hold 1e-3 absolute, the exact path's
tolerance (tests/test_torch_pipeline.py): ten UNet calls and the DDIM chain
on latents of unit scale. ``cfg_cache3`` holds 3e-3: at this input its 9th
step (full, t ≈ 100, right after steps on a stale uncond) multiplies the
latents' fp32 drift (3e-5 after 8 steps) about 150-fold in the noise
prediction, so the port's own fp32 result lies 1.4e-3 from the same code in
fp64 (and the JAX result 2e-4 from it), while the exact sampler agrees with
fp64 to 2e-5 on both sides. The JAX sampler runs jitted, as it serves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import InferenceConfig
from followyourclick_tpu.pipelines import serving_schedules as jss
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.pipelines import serving_schedules as tss
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    PlanStep,
    SampleSpec,
    step_plan,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_pipeline import EXACT, sample_both
from tests.test_torch_unet import TINY_CLIP, TINY_UNET, TINY_VAE, tiny_unet_tree

CFG = InferenceConfig(unet=TINY_UNET, vae=TINY_VAE, clip_text=TINY_CLIP)
F, HW, STEPS = 2, 8, 10


@pytest.fixture(scope="module")
def setup():
    tree = tiny_unet_tree()
    rs = np.random.RandomState(5)
    inputs = dict(
        latents=rs.randn(1, F, HW, HW, 4).astype(np.float32),
        context=(0.5 * rs.randn(2, 77, 768)).astype(np.float32),
        first_image_latents=rs.randn(1, HW, HW, 4).astype(np.float32),
        mask=(rs.rand(1, HW, HW, 1) > 0.5).astype(np.float32),
        fps=np.full((1,), 8.0, np.float32),
        motion_score=np.full((1,), 20.0, np.float32))
    pipe = AnimationPipeline(
        CFG, unet=load_jax_params(UNet3DConditionModel(CFG.unet), tree),
        device="cpu")
    return tree, inputs, pipe


def _spec(cls, name, **kw):
    return cls(video_length=F, height=8 * HW, width=8 * HW,
               num_inference_steps=STEPS, **{**jss.SCHEDULES[name], **kw})


def _port_denoise(pipe, inputs, spec):
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        return pipe.denoise(t["latents"], t["context"], spec,
                            t["first_image_latents"], t["mask"], t["fps"],
                            t["motion_score"]).numpy()


@pytest.mark.parametrize("name,atol", [("pab244_deep4_cfg4_ex", 1e-3),
                                       ("cfg_cache3", 3e-3)])
def test_denoise_matches_jax(setup, name, atol):
    tree, inputs, pipe = setup
    jpipe = JPipeline(CFG, tree, None, None)
    jspec = _spec(JSpec, name)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = np.asarray(jax.jit(lambda p, lat: jpipe.denoise(
        p, lat, j["context"], jspec,
        first_image_latents=j["first_image_latents"], mask=j["mask"],
        fps=j["fps"], motion_score=j["motion_score"]))(
            jpipe.params, j["latents"]))
    got = _port_denoise(pipe, inputs, _spec(SampleSpec, name))
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


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


def _mode(sp, cr, te, deep, j, half=False, deep_ex=False, **kw):
    """The PabMode of position j for intervals (sp, cr, te, deep)."""
    return PabMode(
        record_spatial=sp > 1, record_cross=cr > 1, record_temporal=te > 1,
        record_deep=deep > 1, deep_extrapolate=deep_ex, half=half,
        reuse_spatial=sp > 1 and j % sp != 0,
        reuse_cross=cr > 1 and j % cr != 0,
        reuse_temporal=te > 1 and j % te != 0,
        reuse_deep=deep > 1 and j % deep != 0, **kw)


def test_step_plan_pab488_deep4_cfg4_ex():
    """Period lcm(4, 4, 8, 8, 4) = 8, no warm-up, 2 final exact steps."""
    plan = step_plan(tss.apply_schedule(SampleSpec(num_inference_steps=10),
                                        "pab488_deep4_cfg4_ex"))

    def m(j):
        return _mode(4, 8, 8, 4, j, half=j % 4 != 0)

    want = [PlanStep(i, i, i % 4 == 0, m(i)) for i in range(8)]
    want += [PlanStep(8, 0, True, m(0)), PlanStep(9, 0, True, m(0))]
    assert plan == want
    # the period's position 4 is a full step that runs the trunk and the
    # spatial sites and reuses temporal and cross attention
    assert plan[4].mode.reuse_temporal and not plan[4].mode.reuse_deep


def test_step_plan_pab366_cfg6_w2_fe1():
    """25 steps: 2 warm-up, 3 periods of lcm(6, 3, 6, 6) = 6, a tail of 4
    (positions 0-3 of the period), 1 final exact step."""
    plan = step_plan(tss.apply_schedule(SampleSpec(num_inference_steps=25),
                                        "pab366_cfg6_w2_fe1"))

    def m(j):
        return _mode(3, 6, 6, 1, j, half=j % 6 != 0)

    want = [PlanStep(0, 0, True, m(0)), PlanStep(1, 0, True, m(0))]
    want += [PlanStep(2 + k, k % 6, k % 6 == 0, m(k % 6))
             for k in range(18)]
    want += [PlanStep(20 + k, k, k == 0, m(k)) for k in range(4)]
    want += [PlanStep(24, 0, True, m(0))]
    assert plan == want


def test_step_plan_exact_and_cfg_cache():
    assert step_plan(SampleSpec(num_inference_steps=3)) == [
        PlanStep(i, 0, True, None) for i in range(3)]
    plan = step_plan(tss.apply_schedule(SampleSpec(num_inference_steps=7),
                                        "cfg_cache3"))
    assert [s.full for s in plan] == [True, False, False, True, False, True,
                                      True]
    assert all(s.mode is None for s in plan)


def test_step_plan_trunk_forecast_coefficients():
    plan = step_plan(tss.apply_schedule(SampleSpec(num_inference_steps=10),
                                        "pab488_deep4dex_cfg4_ex"))
    assert [s.mode.deep_ex_coeff for s in plan] == [
        0.0, 0.25, 0.5, 0.75, 0.0, 0.25, 0.5, 0.75, 0.0, 0.0]
    assert all(s.mode.deep_extrapolate for s in plan)


def test_schedules_equal_the_jax_registry():
    assert tss.SCHEDULES == jss.SCHEDULES
    spec = tss.apply_schedule(SampleSpec(), "pab488_deep4_cfg4_ex")
    assert spec.pab_spatial_interval == 4 and spec.deep_cache_interval == 4
    with pytest.raises(KeyError):
        tss.apply_schedule(SampleSpec(), "no_such_schedule")


def test_sample_accepts_every_registered_schedule():
    for name in tss.SCHEDULES:
        spec = tss.apply_schedule(SampleSpec(), name)
        spec.check_ported()
        assert step_plan(spec)[0].full
