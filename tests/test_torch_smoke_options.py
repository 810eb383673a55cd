"""The launch counts ``chip_smoke.py`` holds its T5 and routes phases to.

As ``tests/test_torch_smoke.py``: ``chip_smoke.expected_launches`` runs on
UNets built on the meta device and must give the counts worked out by hand
at 16 f / 512², bf16, one clip. The T5 UNet (``use_text_encoder_2``)
launches as the default one: ``attn_t5`` takes the plain route, as ``attn2``
does. The routes UNet (cross-frame and in-block temporal attention, motion
modules with RoPE and temporal LoRA) takes the modular motion path with
``temporal_attention`` for its 40 motion attentions and 16 in-block
temporal attentions an evaluation, 36 LN-GEGLU feed-forwards (16 spatial,
20 motion), and flash attention for the 4 level-0 cross-frame
self-attentions after the CFG duplication (8192 keys, 16 GiB of scores;
the stem's 8 GiB stays plain). ``_Cross`` blocks take
``fused_temporal_block`` below 1280, ``temporal_attention_dim_div = 2`` the
tiny-sequence kernel everywhere. The written-out rules agree with the
port's ``route``.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from followyourclick_tpu_torch.config import (
    InferenceConfig,
    MotionModuleConfig,
)
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.ops.attention import route
from followyourclick_tpu_torch.pipelines.animation import PlanStep, SampleSpec
from followyourclick_tpu_torch.pipelines.serving_schedules import (
    apply_schedule,
)
from tests.test_torch_smoke import SERVING, _counts

BF16 = torch.bfloat16
ONE_EVAL = [PlanStep(0, 0, True, None)]


def meta_unet(cfg=None, **overrides):
    cfg = InferenceConfig().unet if cfg is None else cfg
    with torch.device("meta"):
        return UNet3DConditionModel(dataclasses.replace(cfg, **overrides))


@pytest.mark.parametrize("spec,want", [
    (SampleSpec(num_inference_steps=4), _counts(80, 64, 0, 0)),
    (SERVING, chip_smoke.SERVING_LAUNCHES)], ids=["exact", "serving"])
def test_t5_unet_launches_as_the_default(spec, want):
    unet = meta_unet(use_text_encoder_2=True)
    assert chip_smoke.expected_launches(unet, spec, BF16) == want


def test_routes_unet_launches():
    unet = meta_unet(chip_smoke.routes_unet(InferenceConfig().unet))
    spec = SampleSpec(num_inference_steps=1)
    assert chip_smoke.expected_launches(unet, spec, BF16, plan=ONE_EVAL) \
        == _counts(0, 36, 0, 56, 4) == chip_smoke.ROUTES_LAUNCHES
    # a serving step that records temporal sites runs the same kernels on
    # its pre-duplicated input: all 5 level-0 attentions above the line
    step = [PlanStep(0, 0, True, PabMode(record_temporal=True))]
    assert chip_smoke.expected_launches(unet, spec, BF16, plan=step) == \
        _counts(0, 36, 0, 56, 5)


@pytest.mark.parametrize("mm,want", [
    (dict(attention_block_types=("Temporal_Self", "Temporal_Cross")),
     _counts(0, 36, 20, 20)),
    (dict(temporal_attention_dim_div=2), _counts(0, 36, 0, 40)),
    (dict(use_rope_position_encoding=True), _counts(0, 36, 0, 40)),
    (dict(add_temporal_lora=True), _counts(0, 36, 0, 40))],
    ids=["cross", "dim_div2", "rope", "lora"])
def test_motion_option_launches(mm, want):
    unet = meta_unet(motion_module=MotionModuleConfig(**mm))
    spec = SampleSpec(num_inference_steps=1)
    assert chip_smoke.expected_launches(unet, spec, BF16,
                                        plan=ONE_EVAL) == want


def test_temporal_attention_is_reused_under_pab():
    """A serving schedule that reuses temporal sites skips the in-block
    temporal attention on its reuse steps, as the motion attentions."""
    unet = meta_unet(unet_use_temporal_attention=True)
    spec = apply_schedule(SampleSpec(num_inference_steps=10),
                          chip_smoke.SERVING_SCHEDULE)
    base = chip_smoke.expected_launches(meta_unet(), spec, BF16)
    got = chip_smoke.expected_launches(unet, spec, BF16)
    # 16 in-block temporal attentions on each of the 3 full steps that
    # compute temporal sites
    assert got == {**base, "temporal_attention":
                   base["temporal_attention"] + 3 * 16}


@pytest.mark.parametrize("rows", [16, 24, 32, 64])
@pytest.mark.parametrize("tokens", [256, 1024, 4096])
def test_cross_frame_flash_line_is_the_ports_route(rows, tokens):
    q, k = (rows, tokens, 8, 40), (rows, 2 * tokens, 8, 40)
    assert chip_smoke.flash_line(rows, tokens, 8, 2 * tokens) == (
        route(q, k, False) == "flash")


@pytest.mark.parametrize("frames", [1, 16, 24, 32, 33])
@pytest.mark.parametrize("heads", [4, 8, 16])
def test_tiny_line_is_the_ports_route(frames, heads):
    shape = (64, frames, heads, 40)
    assert chip_smoke.tiny_line(frames, heads) == (
        route(shape, shape, False) == "tiny")


def test_t5_checks_reject_their_controls():
    """The T5 phase's checks on a tiny bf16 encoder: each RMSNorm computed
    in fp32 stays within ``T5_NORM_REL_L2`` of its fp64 formula and the
    same norm computed in bf16 does not; an encode that strays from fp32
    fails ``t5_encode_ok``."""
    from followyourclick_tpu_torch.models.t5_text import (
        T5Config,
        T5EncoderModel,
    )

    torch.manual_seed(0)
    t5 = T5EncoderModel(T5Config(vocab_size=200, d_model=64, d_kv=16,
                                 d_ff=128, num_layers=2, num_heads=4)
                        ).to(BF16)
    ids = torch.randint(0, 200, (2, 12))

    def encode():
        return t5(ids)

    assert chip_smoke.t5_norm_error(t5, encode) <= chip_smoke.T5_NORM_REL_L2
    with chip_smoke.rmsnorm_in_input_dtype():
        assert chip_smoke.t5_norm_error(t5, encode) \
            > chip_smoke.T5_NORM_REL_L2
    with torch.inference_mode():
        states = encode()
    want = states.float()
    assert chip_smoke.t5_encode_ok(states, want, (2, 12, 64))
    assert not chip_smoke.t5_encode_ok(states, want, (2, 12, 32))
    assert not chip_smoke.t5_encode_ok(states, want * 1.1, (2, 12, 64))
