"""Serving and the dry run on a ``(data, model)`` grid of ``gloo`` ranks.

Tiny requests through ``AnimationPipeline(mesh=)`` on a 2 x 2 grid
(``tests/_torch_tp_ranks.requests``: UNet and VAE sharded over ``model``,
CLIP replicated, one clip a data rank, the videos gathered) against the
same requests in one process: one on the exact sampler (3 DDIM steps, CFG
7.5), one under ``pab488_deep4_cfg4_ex`` (10 steps: PAB reuse, the
DeepCache trunk and the CFG cache over the sharded modules) and one on
Euler-A with ``video_scale = 1.5`` (2 steps: each step's fresh noise and
the per-frame pass's contexts, taken for the whole request and sliced by
the data rank), 2 clips of 4
frames at 64² (the tiny two-level UNet of ``tests/test_torch_training_step
.py``, a four-level VAE of width 32, a two-layer CLIP; every weight drawn
from a seed, no layer zero), fp32 on the CPU. The ranks' videos equal the
one-process videos within ``VIDEO_ATOL`` on [0, 1] and every rank returns
the whole request's video.

The dry run: ``entry.dryrun_multichip(4, device="cpu")`` builds JAX's grid
(``{'data': 2, 'model': 2}``), prints JAX's ``mesh=`` line, and its loss,
``grad_norm`` and video equal the port's one-process dry run over the same
global batch of 2 clips (``entry.dryrun_run`` on a one-process mesh):
loss and ``grad_norm`` within ``DRYRUN_REL`` relative (the dry run's
frozen leaves are bf16, as JAX's: each rank rounds its own partial
products) and the video within ``DRYRUN_VIDEO_ATOL``. JAX's own dry-run
weights and draws come from ``jax.random``, which the port does not
reproduce, so the one-process port run is the reference here.
"""

import os

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch import entry
from followyourclick_tpu_torch.config import (
    CLIPTextConfig,
    InferenceConfig,
    VAEConfig,
)
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.parallel.mesh import create_mesh
from followyourclick_tpu_torch.pipelines.animation import (
    AnimationPipeline,
    SampleSpec,
)
from followyourclick_tpu_torch.pipelines.serving_schedules import (
    apply_schedule,
)
from tests import _torch_tp_ranks
from tests.test_torch_data_parallel import port_config
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import UNET

GRID = (2, 2)
CLIPS, FRAMES, SIDE = 2, 4, 64
VIDEO_ATOL = 1e-4
DRYRUN_REL = 1e-3
DRYRUN_VIDEO_ATOL = 2e-3
SPECS = {
    "exact": SampleSpec(video_length=FRAMES, height=SIDE, width=SIDE,
                        num_inference_steps=3, guidance_scale=7.5),
    "pab488_deep4_cfg4_ex": apply_schedule(SampleSpec(
        video_length=FRAMES, height=SIDE, width=SIDE,
        num_inference_steps=10, guidance_scale=7.5), "pab488_deep4_cfg4_ex"),
    # fresh noise every step and the per-frame pass: the draws and the
    # per-frame contexts of the whole request, each data rank's rows kept
    "euler_a_video_scale": SampleSpec(
        video_length=FRAMES, height=SIDE, width=SIDE, num_inference_steps=2,
        guidance_scale=7.5, scheduler="euler_a", video_scale=1.5),
}
TEXT = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=2)
CONFIG = InferenceConfig(
    unet=port_config(UNET),
    vae=VAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                  norm_num_groups=8, sample_size=SIDE),
    clip_text=TEXT)


def seeded(module, seed):
    """Every parameter from a seed: weights N(0, 1/fan_in), norm scales
    1 + N(0, 0.05²), biases N(0, 0.02²)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                p.copy_(z / np.sqrt(p[0].numel()))
            elif "norm" in n and n.endswith("weight"):
                p.copy_(1.0 + 0.05 * z)
            else:
                p.copy_(0.02 * z)
    return module


def models():
    return (seeded(UNet3DConditionModel(CONFIG.unet), 1),
            seeded(AutoencoderKL(CONFIG.vae), 2),
            seeded(CLIPTextModel(CONFIG.clip_text), 3).eval())


def request_inputs():
    g = torch.Generator().manual_seed(5)
    h = SIDE // 8
    return (torch.randint(0, TEXT.vocab_size, (CLIPS, 77), generator=g),
            torch.zeros(CLIPS, 77, dtype=torch.long),
            torch.randn(CLIPS, h, h, 4, generator=g),
            (torch.rand(CLIPS, h, h, 1, generator=g) > 0.5).float(),
            torch.tensor([8.0, 12.0]), torch.tensor([20.0, 35.0]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    unet, vae, text = models()
    path = os.path.join(tmp_path_factory.mktemp("tp_sample"), "job.pt")
    torch.save({"grid": GRID, "config": CONFIG,
                "unet_state": unet.state_dict(), "vae_state": vae.state_dict(),
                "text_state": text.state_dict(), "inputs": request_inputs(),
                "specs": list(SPECS.values()), "seed": 11}, path)
    out = dp.launch(_torch_tp_ranks.requests, GRID[0] * GRID[1], (path,),
                    timeout=240.0)
    assert not any(r["jax_loaded"] for r in out)
    return out


@pytest.mark.parametrize("index,name", list(enumerate(SPECS)))
def test_grid_request_equals_one_process(ranks, index, name):
    pipe = AnimationPipeline(CONFIG, *models(), device="cpu")
    want = pipe.sample(*request_inputs(), spec=SPECS[name],
                       generator=torch.Generator().manual_seed(11))
    assert want.shape == (CLIPS, FRAMES, SIDE, SIDE, 3)
    assert float(want.std()) > 1e-3
    for r in ranks:
        got = r["videos"][index]
        err = float((got - want).abs().max())
        print(f"{name}, rank {r['rank']}: max |grid - one process| {err:.3e}")
        assert got.shape == want.shape and err <= VIDEO_ATOL, (name, err)


def test_dryrun_prints_the_jax_mesh_and_matches_one_process(capfd):
    out = entry.dryrun_multichip(4, device="cpu")
    printed = capfd.readouterr().out
    assert entry.dryrun_grid(4) == (2, 2) and entry.dryrun_grid(8) == (4, 2)
    assert entry.dryrun_grid(3) == (3, 1)
    assert out["mesh"] == {"data": 2, "model": 2}
    assert ("dryrun_multichip(4): mesh={'data': 2, 'model': 2} loss="
            in printed), printed
    assert "dryrun_multichip(4): sharded-serving checksum=" in printed
    assert "video=(2, 4, 64, 64, 3)" in printed
    one = entry.dryrun_run(create_mesh(), torch.device("cpu"), batch=2)
    for k in ("loss", "grad_norm"):
        assert abs(out[k] - one[k]) <= DRYRUN_REL * abs(one[k]), (k, out, one)
    err = float((out["video"] - one["video"]).abs().max())
    assert err <= DRYRUN_VIDEO_ATOL, err
