"""The port's tiny sampler under every solver against the JAX sampler.

As ``tests/test_torch_pipeline.py``: the JAX ``_sample_jit`` and the port's
``AnimationPipeline.sample`` run the same request at the tiny configs
(4 frames, 64², CFG 8), the same parameters (by ``load_jax_params``), JAX's
initial noise injected into the port, fp32 on the CPU, the video held to
1e-3 absolute. Here the request runs Euler, DPM-Solver++ (order 2), PNDM
with the PRK warm-up grid (6 steps, 15 UNet calls: the plan is longer than
the steps) and Euler-A, whose per-step draws are JAX's own
(``normal(fold_in(rng, i))`` of the split key), injected through
``step_noise`` as the initial noise is, since the two PRNGs differ.

:func:`sample_both` is the harness of the other ``test_torch_sampler_
options_*`` files: requests without CFG (the JAX ``_sample_jit`` always
doubles the context, so its pieces run with the cond rows), with a camera
type, a partial mask and LoRA-merged weights.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu.schedulers.dispatch import make_solver as jax_solver
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    SampleSpec,
)
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_pipeline import CFG, EXACT, F, H, W, _request
from tests.test_torch_unet import tiny_clip_tree, tiny_unet_tree, tiny_vae_tree
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

ATOL = 1e-3


def _jax_no_cfg(jpipe, b):
    """``_sample_jit`` with the context cut to its cond rows, as the
    reference pipeline encodes without CFG."""

    @functools.partial(jax.jit, static_argnames=("spec",))
    def run(params, ids, neg, key, spec, first_image_latents, mask, fps,
            motion_score, camera_motion_type, partial_mask):
        context = jpipe.encode_prompt(params, ids, neg)[b:]
        latents = jpipe.prepare_latents(
            key, b, spec, init_latents=(first_image_latents
                                        if spec.use_first_image_as_init_latents
                                        else None))
        latents = jpipe.denoise(
            params, latents, context, spec,
            first_image_latents=first_image_latents, mask=mask,
            partial_mask=partial_mask, fps=fps, motion_score=motion_score,
            camera_motion_type=camera_motion_type)
        return jpipe.decode_latents(params, latents)

    return run


def sample_both(spec_kw, b=1, seed=0, cfg=CFG, camera=None, partial=False,
                unet_tree=None, port_unet=None, jax_side=True):
    """One tiny request of ``b`` clips through the JAX sampler and the
    port's ``sample``, as numpy (the JAX video None when not ``jax_side``:
    the port alone, with JAX's noise). ``camera``: the clips' camera-motion
    types; ``partial``: a random 0/1 partial mask on the first-frame latent;
    ``unet_tree`` the JAX parameters (default the config's random tree) and
    ``port_unet`` the port's UNet (default those parameters loaded)."""
    trees = dict(unet=tiny_unet_tree(cfg.unet) if unet_tree is None
                 else unet_tree, vae=tiny_vae_tree(),
                 text_encoder=tiny_clip_tree())
    req = _request(seed, b)
    if camera is not None:
        req["camera_motion_type"] = np.asarray(camera, np.float32)
    if partial:
        rs = np.random.RandomState(seed + 50)
        req["partial_mask"] = (rs.rand(b, H // 8, W // 8, 1) > 0.3).astype(
            np.float32)
    spec = JSpec(**spec_kw)
    key = jax.random.PRNGKey(7)
    stochastic = spec.eta > 0 or spec.scheduler == "euler_a"
    noise_key, eta_key = jax.random.split(key) if stochastic else (key, None)
    shape = (b, F, H // 8, W // 8, 4)

    def on(name, wrap):
        v = req.get(name)
        return None if v is None else wrap(np.asarray(v))

    jpipe = JPipeline(cfg, trees["unet"], trees["vae"],
                      trees["text_encoder"])
    kw = {k: on(k, jnp.asarray) for k in (
        "first_image_latents", "mask", "fps", "motion_score",
        "camera_motion_type", "partial_mask")}
    ids, neg = jnp.asarray(req["input_ids"]), jnp.asarray(
        req["neg_input_ids"])
    want = None
    if not jax_side:
        pass
    elif spec.guidance_scale > 1.0:
        want = np.asarray(jpipe._sample_jit(jpipe.params, ids, neg, key,
                                            spec, **kw))
    else:
        assert not stochastic
        want = np.asarray(_jax_no_cfg(jpipe, b)(jpipe.params, ids, neg, key,
                                                spec, **kw))
    noise = np.asarray(jax.random.normal(noise_key, shape))
    step_noise = None
    if stochastic:
        n = jax_solver(spec.scheduler, cfg.noise_scheduler,
                       spec.num_inference_steps).n_calls
        step_noise = torch.tensor(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(eta_key, i), shape)) for i in range(n)]))

    if port_unet is None:
        port_unet = load_jax_params(UNet3DConditionModel(cfg.unet),
                                    trees["unet"])
    pipe = AnimationPipeline(
        cfg, unet=port_unet,
        vae=load_jax_params(AutoencoderKL(cfg.vae), trees["vae"]),
        text_encoder=load_jax_params(CLIPTextModel(cfg.clip_text),
                                     trees["text_encoder"]), device="cpu")
    got = pipe.sample(**{k: on(k, torch.from_numpy) for k in req},
                      spec=SampleSpec(**spec_kw), noise=torch.tensor(noise),
                      step_noise=step_noise).numpy()
    assert got.shape == (b, F, H, W, 3)
    assert want is None or want.shape == got.shape
    assert np.isfinite(got).all() and got.std() > 1e-3
    return got, want


@pytest.mark.parametrize("scheduler,steps", [("euler", 2), ("dpm++", 4),
                                             ("pndm_prk", 6),
                                             ("euler_a", 2)])
def test_solver_matches_jax(scheduler, steps):
    """Each solver's whole request: ``init_noise_sigma``, the model-input
    scaling, float timesteps (Euler), the multistep state (DPM-Solver++ at
    second order, PNDM) and the PRK grid's 15 calls for 6 steps.

    The step counts are ones where the tiny random UNet's trajectory is
    well conditioned. At some timesteps it amplifies a 1e-5 difference of
    its input latents ~260-fold (random weights), so that the JAX sampler
    jitted and run eagerly lie 2.5e-2 apart in the final latents at
    DPM-Solver++ 3 steps and 7.4e-2 at PRK 4 steps, against 7.7e-5 at
    DPM-Solver++ 4 steps and 2.4e-3 at PRK 6 steps; the port is held where
    JAX reproduces itself."""
    got, want = sample_both(dict(EXACT, scheduler=scheduler,
                                 num_inference_steps=steps))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

