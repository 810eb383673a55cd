"""The launch counts that ``chip_smoke.py`` holds its main paths to.

``chip_smoke.expected_launches`` works each kernel's launches out from a
request's ``step_plan`` and the UNet's module tree alone, with the
whole-block motion kernel's fit rule written out. Here it runs on the
default ``InferenceConfig`` UNet built on the meta device (no weights are
allocated) and must give the counts worked out by hand: on the serving
path the smoke's own ``SERVING_LAUNCHES``, on the exact path 20 whole-block
motion kernels and 16 LN-GEGLU feed-forwards per step, and in fp32 the
modular route for the blocks at C ≥ 640.
"""

import pytest
import torch

import chip_smoke
from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.pipelines.animation import (
    SampleSpec,
    step_plan,
)
from followyourclick_tpu_torch.pipelines.serving_schedules import (
    apply_schedule,
)


@pytest.fixture(scope="module")
def meta_unet():
    with torch.device("meta"):
        return UNet3DConditionModel(InferenceConfig().unet)


def _counts(motion, geglu, block, attn):
    return {"fused_motion_block": motion, "fused_ln_geglu": geglu,
            "fused_temporal_block": block, "temporal_attention": attn}


@pytest.mark.parametrize("spec, dtype, want", [
    (apply_schedule(SampleSpec(num_inference_steps=chip_smoke.SERVING_STEPS),
                    chip_smoke.SERVING_SCHEDULE), torch.bfloat16,
     chip_smoke.SERVING_LAUNCHES),
    (SampleSpec(num_inference_steps=4), torch.bfloat16, _counts(80, 64, 0, 0)),
    # fp32: the 5 blocks at C = 320 fit the whole-block kernel; the 15 at
    # 640 and 1280 take the modular path (their FFs join the 16 spatial)
    (SampleSpec(num_inference_steps=1), torch.float32, _counts(5, 31, 10, 20)),
], ids=["serving", "exact-bf16", "exact-fp32"])
def test_expected_launches_match_the_hand_count(meta_unet, spec, dtype, want):
    assert chip_smoke.expected_launches(meta_unet, step_plan(spec),
                                        dtype) == want
