"""The port's drift harness (``utils/quality.py``) against the JAX
harness on one tree.

One tiny JAX quality tree (the JAX ``build_quality_pipeline("tiny",
seed=0)``) is loaded into the port's ``build_quality_pipeline("tiny")``
modules by ``load_jax_params``, and the port's ``run_schedule`` is fed the
JAX ``jax.random`` draws (``JaxDraws``). The port's recipe (first-latent
scale, mask threshold, prompt-id range, empty negative ids, fps and motion
score, noise key) then gives the JAX ``run_schedule``'s video, exact and
``pab244_deep4_cfg4_ex``, at 1e-3 absolute on [0, 1] (4 frames at 64², 6
steps: one period of 4 and the 2 final exact steps, as
``tests/test_torch_pipeline_call.py``), and the drift of the one from the
other agrees at 1e-3 in relative L2 and 0.01 dB in PSNR (the step to
which ``drift_metrics`` rounds it). The JAX ``build_quality_pipeline``
runs with each flax ``init`` replaced by ``tests/test_torch_unet.
random_tree`` (the shapes of ``init`` traced, the values from a numpy
seed, no layer zero): flax's eager init took ~70 s of the file's ~150 s
on one worker, and under ``jax.jit`` ~60 s.
"""

import functools
from unittest import mock

import flax.linen as fnn
import jax
import numpy as np
import pytest

from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu.pipelines.serving_schedules import (
    apply_schedule as japply,
)
from followyourclick_tpu.utils import quality as jquality
from followyourclick_tpu_torch.pipelines.animation import SampleSpec
from followyourclick_tpu_torch.pipelines.serving_schedules import (
    apply_schedule,
)
from followyourclick_tpu_torch.utils import quality
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_unet import random_tree


class JaxDraws:
    """The JAX harness's draws: ``jax.random`` from ``PRNGKey(key)``."""

    @staticmethod
    def normal(key, shape):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape))

    @staticmethod
    def uniform(key, shape):
        return np.asarray(jax.random.uniform(jax.random.PRNGKey(key), shape))

    @staticmethod
    def randint(key, shape, low, high):
        return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape,
                                             low, high))


JF, JPX, JHL = 4, 64, 8
JBASE = dict(video_length=JF, height=JPX, width=JPX, num_inference_steps=6,
             guidance_scale=8.0, use_interpolate_noise=True)


@pytest.fixture(scope="module")
def both_harnesses():
    """(JAX pipeline, port pipeline on the same tree, {schedule: (JAX
    video, port video)})."""
    init = fnn.Module.init

    def traced_init(module, rngs, *args, **kwargs):
        return {"params": random_tree(functools.partial(init, module,
                                                        **kwargs), *args)}

    with mock.patch.object(fnn.Module, "init", traced_init):
        jpipe = jquality.build_quality_pipeline("tiny", seed=0)
    tpipe = quality.build_quality_pipeline("tiny", seed=0, device="cpu")
    for name in ("unet", "vae", "text_encoder"):
        load_jax_params(getattr(tpipe, name), jpipe.params[name])
    return jpipe, tpipe, {}


def _videos(both_harnesses, name):
    jpipe, tpipe, done = both_harnesses
    if name not in done:
        jspec, tspec = JSpec(**JBASE), SampleSpec(**JBASE)
        if name != "exact":
            jspec, tspec = japply(jspec, name), apply_schedule(tspec, name)
        done[name] = (jquality.run_schedule(jpipe, jspec, JF, (JHL, JHL)),
                      quality.run_schedule(tpipe, tspec, JF, (JHL, JHL),
                                           draws=JaxDraws))
    return done[name]


@pytest.mark.parametrize("name", ["exact", "pab244_deep4_cfg4_ex"])
def test_run_schedule_matches_jax(both_harnesses, name):
    want, got = _videos(both_harnesses, name)
    assert got.shape == want.shape == (1, JF, JPX, JPX, 3)
    assert np.isfinite(got).all() and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_schedule_drift_matches_jax(both_harnesses):
    jexact, texact = _videos(both_harnesses, "exact")
    japprox, tapprox = _videos(both_harnesses, "pab244_deep4_cfg4_ex")
    want = jquality.drift_metrics(japprox, jexact)
    got = quality.drift_metrics(tapprox, texact)
    assert want["rel_l2"] > 1e-4, want
    assert abs(got["rel_l2"] - want["rel_l2"]) <= 1e-3, (got, want)
    assert abs(got["psnr_db"] - want["psnr_db"]) <= 0.01 + 1e-9, (got, want)
    print("drift", got, want)
