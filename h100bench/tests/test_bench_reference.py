"""The plain reference against the port on the CPU at a tiny size: the same
seeded weights load into both by name, and every model gives the same
numbers in float32."""

from __future__ import annotations

import pytest
import torch

from h100bench.drivers.sampler import build_pipeline, rel_l2
from h100bench.harness.weights import (
    DTYPES,
    reference_models,
    seeded_state,
    shapes_of,
)
from h100bench.reference import ops
from h100bench.reference.sampler import DDIM
from h100bench.reference.train import frame_crops, trainable
from h100bench.tests.tiny import tiny_config

SEED = 3_000_000_011  # above 32 bits: a run's seed may be that large


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def both():
    cfg = tiny_config()
    return cfg, build_pipeline(cfg, SEED, "cpu"), reference_models(
        cfg, SEED, "cpu")


def test_weights_load_by_name_into_both(both):
    cfg, pipe, ref = both
    for name, mine in (("unet", pipe.unet), ("vae", pipe.vae),
                       ("text", pipe.text_encoder)):
        theirs = dict(ref[name].named_parameters())
        ours = dict(mine.named_parameters())
        assert set(ours) == set(theirs), name
        for k, v in ours.items():
            assert torch.equal(v.float(), theirs[k]), (name, k)


def test_weights_repeat_from_the_seed():
    shapes = {"a.weight": (8, 4), "a.bias": (8,), "n.weight": (4,)}
    one = seeded_state(shapes, SEED, "cpu", torch.bfloat16)
    two = seeded_state(dict(reversed(list(shapes.items()))), SEED, "cpu",
                       torch.bfloat16)
    for k in shapes:
        assert torch.equal(one[k], two[k])
    assert not torch.equal(one["a.weight"], seeded_state(
        shapes, SEED + 1, "cpu", torch.bfloat16)["a.weight"])


def test_zero_initialised_layers_get_small_weights(both):
    cfg, pipe, _ = both
    unet = pipe.unet
    for name, p in unet.named_parameters():
        if name.endswith(("motion_embedding.linear_2.weight",
                          "fps_embedding.linear_2.weight")) or (
                "motion_modules" in name and "proj_out.weight" in name):
            assert 0.0 < float(p.detach().float().std()) < 0.03, name


def test_text_encoders_agree(both):
    cfg, pipe, ref = both
    ids = torch.randint(0, 49407, (2, 77), generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        got = pipe.text_encoder(ids)[0]
        want = ref["text"](ids)
    assert rel_l2(got, want) < 1e-5


def test_vaes_agree(both):
    cfg, pipe, ref = both
    g = torch.Generator().manual_seed(2)
    image = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    z = torch.randn(3, 8, 8, 4, generator=g)
    with torch.no_grad():
        m1, l1 = pipe.vae.encode(image)
        m2, l2 = ref["vae"].encode(image)
        assert rel_l2(m1, m2) < 1e-5 and rel_l2(l1, l2) < 1e-5
        assert rel_l2(pipe.vae.decode(z), ref["vae"].decode(z)) < 1e-5


def test_unets_agree_under_guidance(both):
    """The port shares the stem of the two halves; the reference runs
    both."""
    from followyourclick_tpu_torch.models.unet3d import UNetConditioning

    cfg, pipe, ref = both
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 8, 8, 9, generator=g)
    ctx = torch.randn(2, 77, 32, generator=g)
    t = torch.tensor([961])
    fps, motion = torch.tensor([8.0]), torch.tensor([17.0])
    with torch.no_grad():
        got = pipe.unet(x, t, UNetConditioning(context=ctx, fps=fps,
                                               motion_score=motion))
        want = ref["unet"](torch.cat([x, x]), t.repeat(2), ctx,
                           fps.repeat(2), motion.repeat(2))
    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-5


def test_control_rounds_through_float8():
    x = torch.linspace(-3, 3, 1001)
    q = ops.Precision("fp8").q(x)
    err = rel_l2(q, x)
    assert 5e-3 < err < 6e-2
    assert torch.equal(ops.FP32.q(x), x)


def test_ddim_tables_match_the_port():
    from followyourclick_tpu_torch.config import NoiseScheduleConfig
    from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule

    cfg = tiny_config()["noise_scheduler"]
    mine = DDIM(cfg, 25)
    theirs = DDIMSchedule.create(NoiseScheduleConfig.from_dict(cfg), 25)
    assert mine.timesteps == theirs.timesteps.tolist()
    assert torch.allclose(mine.alphas_cumprod.float(),
                          theirs.alphas_cumprod, rtol=1e-4, atol=1e-7)


def test_crops_match_the_loop():
    import dataclasses

    import numpy as np
    from followyourclick_tpu_torch.training.loop import _subsample_frames

    @dataclasses.dataclass
    class Clip:
        latents: torch.Tensor

    rng = np.random.RandomState(1234)
    lat = torch.arange(24.0)[None, :, None, None, None]
    for start, nf in frame_crops(12, 24, 8):
        got = _subsample_frames(Clip(lat), rng, 8).latents
        assert got[0, :, 0, 0, 0].tolist() == list(range(start, start + nf))


def test_trainable_leaves_match_the_port():
    from followyourclick_tpu_torch.config import UNet3DConfig
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.training.step import trainable_mask

    cfg = tiny_config("fyc-train-sd15-motion")
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig.from_dict(cfg["unet"]))
    prefixes = tuple(cfg["train"]["trainable_modules"])
    theirs = trainable_mask(unet, prefixes)
    assert {n: trainable(n, prefixes) for n in theirs} == theirs
    assert any(theirs.values()) and not all(theirs.values())


def test_dtypes_cover_the_configs():
    assert tiny_config()["dtype"] in DTYPES
    assert ops.FP32.kind == "fp32"
    assert shapes_of(torch.nn.Linear(2, 3)) == {"weight": (3, 2),
                                                "bias": (3,)}
