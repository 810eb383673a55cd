"""Serving on a ``(data, model) = (2, 2)`` grid against JAX's sharded
sampler.

The port's ``AnimationPipeline(mesh=)`` over four ``gloo`` ranks
(``tests/_torch_tp_ranks.requests``: UNet and VAE sharded over ``model``,
CLIP replicated, one clip a data rank, the video gathered) against JAX's
``AnimationPipeline(mesh=create_mesh(data=2, model=2))``, whose UNet and
VAE trees are placed by JAX's ``shard_params`` and whose clip inputs sit on
``P("data")``, as in JAX's dry run (``__graft_entry__.py``). The same
random trees go to both (``load_jax_params``), and JAX's own draws are
passed to the port: the initial noise of the whole request and, for
Euler-A, each step's fresh noise (``noise`` / ``step_noise``), which each
data rank slices. Requests of the tiny models of
``tests/test_torch_tensor_parallel_sampling.py`` (2 clips of 4 frames at
64², fp32 on the CPU): here the exact sampler (3 DDIM steps, CFG 7.5) and
Euler-A with ``video_scale = 1.5`` (2 steps: the fresh noise and the
per-frame pass's contexts of the whole request, taken by the data rank);
``pab488_deep4_cfg4_ex`` (10 steps: PAB reuse, the DeepCache trunk and the
CFG cache over the sharded modules) in
``tests/test_torch_tensor_parallel_sampling_pab_jax.py``, a file of its
own so that each file's JAX compiles stay short.

Tolerance: every rank's video within ``VIDEO_ATOL`` of JAX's on [0, 1],
the bound the grid holds to the port's one-process run
(``tests/test_torch_tensor_parallel_sampling.py``); the largest difference
seen is 6.1e-6 (fp32, both packages on the CPU). A wrong split or a clip
dealt to the wrong data rank moves the video by order 0.1.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import CLIPTextConfig, InferenceConfig
from followyourclick_tpu.config import VAEConfig
from followyourclick_tpu.models.clip_text import CLIPTextModel as JCLIP
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.models.vae import AutoencoderKL as JVAE
from followyourclick_tpu.parallel.mesh import create_mesh
from followyourclick_tpu.parallel.sharding import shard_params
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu.pipelines.animation import SampleSpec as JSpec
from followyourclick_tpu.pipelines.serving_schedules import apply_schedule
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.pipelines.animation import SampleSpec
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests import _torch_tp_ranks
from tests.test_torch_data_parallel import port_config
from tests.test_torch_tensor_parallel_sampling import (
    CLIPS,
    FRAMES,
    GRID,
    SIDE,
    request_inputs,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import UNET
from tests.test_torch_unet import random_tree

VIDEO_ATOL = 1e-4
KEY = 11
JCONFIG = InferenceConfig(
    unet=UNET,
    vae=VAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                  norm_num_groups=8, sample_size=SIDE),
    clip_text=CLIPTextConfig(vocab_size=100, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=2))
SPECS = {
    "exact": JSpec(video_length=FRAMES, height=SIDE, width=SIDE,
                   num_inference_steps=3, guidance_scale=7.5),
    "pab488_deep4_cfg4_ex": apply_schedule(JSpec(
        video_length=FRAMES, height=SIDE, width=SIDE,
        num_inference_steps=10, guidance_scale=7.5), "pab488_deep4_cfg4_ex"),
    "euler_a_video_scale": JSpec(
        video_length=FRAMES, height=SIDE, width=SIDE, num_inference_steps=2,
        guidance_scale=7.5, scheduler="euler_a", video_scale=1.5),
}


def trees():
    h = SIDE // 8
    cond = JCond(context=jnp.zeros((2, 77, JCONFIG.clip_text.hidden_size)),
                 fps=jnp.full((1,), 8.0), motion_score=jnp.full((1,), 20.0))
    return {
        "unet": random_tree(JUNet(JCONFIG.unet).init,
                            jnp.zeros((1, FRAMES, h, h, 9)),
                            jnp.zeros((1,), jnp.int32), cond, seed=21),
        "vae": random_tree(JVAE(JCONFIG.vae).init,
                           jnp.zeros((1, SIDE, SIDE, 3)),
                           jax.random.PRNGKey(0), seed=22),
        "text_encoder": random_tree(JCLIP(JCONFIG.clip_text).init,
                                    jnp.zeros((1, 77), jnp.int32), seed=23)}


def jax_draws(spec):
    """The initial noise and the per-step noise ``_sample_jit`` draws from
    ``PRNGKey(KEY)`` (the noise is the raw draw, before the spec's
    interpolation, as the port's ``noise=`` takes it)."""
    key = jax.random.PRNGKey(KEY)
    shape = (CLIPS, FRAMES, SIDE // 8, SIDE // 8, 4)
    if spec.scheduler != "euler_a":
        return {"noise": torch.tensor(np.asarray(
            jax.random.normal(key, shape)))}
    noise_key, step_key = jax.random.split(key)
    steps = [jax.random.normal(jax.random.fold_in(step_key, i), shape)
             for i in range(spec.num_inference_steps)]
    return {"noise": torch.tensor(np.asarray(
                jax.random.normal(noise_key, shape))),
            "step_noise": torch.tensor(np.asarray(jnp.stack(steps)))}


def jax_videos(params, names):
    """Each request of ``names`` through JAX's sampler on the 2 x 2
    mesh."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    ids, neg, first, mask, fps, score = (
        jnp.asarray(t.numpy()) for t in request_inputs())
    mesh = create_mesh(data=GRID[0], model=GRID[1],
                       devices=jax.devices()[:GRID[0] * GRID[1]])
    data = NamedSharding(mesh, P("data"))
    with mesh:
        pipe = JPipeline(JCONFIG, None, None, None, mesh=mesh)
        pipe.params = {"unet": shard_params(params["unet"], mesh),
                       "vae": shard_params(params["vae"], mesh),
                       "text_encoder": params["text_encoder"]}
        put = lambda x: jax.device_put(x, data)  # noqa: E731
        return {name: torch.from_numpy(np.array(pipe._sample_jit(
            pipe.params, put(ids.astype(jnp.int32)),
            put(neg.astype(jnp.int32)), jax.random.PRNGKey(KEY), spec,
            first_image_latents=put(first), mask=put(mask), fps=put(fps),
            motion_score=put(score))))
            for name, spec in SPECS.items() if name in names}


def run_both(tmp_path_factory, names):
    """The requests ``names`` on the grid of ``gloo`` ranks (their
    videos, by rank) and through JAX's sampler on the mesh (by name)."""
    params = trees()
    cfg = port_config(JCONFIG)
    path = os.path.join(tmp_path_factory.mktemp("tp_sample_jax"), "job.pt")
    torch.save({
        "grid": GRID, "config": cfg,
        "unet_state": load_jax_params(UNet3DConditionModel(cfg.unet),
                                      params["unet"]).state_dict(),
        "vae_state": load_jax_params(AutoencoderKL(cfg.vae),
                                     params["vae"]).state_dict(),
        "text_state": load_jax_params(CLIPTextModel(cfg.clip_text),
                                      params["text_encoder"]).state_dict(),
        "inputs": request_inputs(),
        "specs": [SampleSpec(**{f.name: getattr(SPECS[n], f.name)
                                for f in dataclasses.fields(SampleSpec)})
                  for n in names],
        "draws": [jax_draws(SPECS[n]) for n in names]}, path)
    ranks = dp.launch(_torch_tp_ranks.requests, GRID[0] * GRID[1], (path,),
                      timeout=240.0)
    assert not any(r["jax_loaded"] for r in ranks)
    return ranks, jax_videos(params, names)


def check_request(both, index, name):
    ranks, want = both
    want = want[name]
    assert want.shape == (CLIPS, FRAMES, SIDE, SIDE, 3)
    assert float(want.std()) > 1e-3
    for r in ranks:
        got = r["videos"][index]
        err = float((got - want).abs().max())
        print(f"{name}, rank {r['rank']}: max |grid - JAX 2x2| {err:.3e}")
        assert got.shape == want.shape and err <= VIDEO_ATOL, (name, err)


NAMES = ("exact", "euler_a_video_scale")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory, NAMES)


@pytest.mark.parametrize("index,name", list(enumerate(NAMES)))
def test_grid_request_equals_jax_sharded_sampler(both, index, name):
    check_request(both, index, name)
