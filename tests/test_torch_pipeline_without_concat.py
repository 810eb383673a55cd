"""The port's tiny sampler against the JAX pipeline for a UNet without the
click-mask concat (a 4-channel ``conv_in``, no first-frame latent or mask
passed), on the exact sampler and under a PAB serving schedule, whose
pre-duplicated input is built apart from the exact path's; the harness and
tolerance of ``tests/test_torch_pipeline.py``.
"""

import numpy as np
import pytest

from followyourclick_tpu.pipelines.serving_schedules import SCHEDULES
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from tests.test_torch_pipeline import EXACT, NO_CONCAT, sample_both
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("spec_kw", [
    EXACT,
    # one period of 4 and the 2 final exact steps: the PAB path's
    # pre-duplicated input (build_x)
    dict(EXACT, num_inference_steps=6, **SCHEDULES["pab244_deep4_cfg4_ex"])],
    ids=["exact", "pab244_deep4_cfg4_ex"])
def test_tiny_sample_without_mask_concat_matches_jax(spec_kw):
    """A UNet without ``use_first_frame_mask_condition_concat`` takes the
    bare latents (4 channels), and the request carries no first-frame
    latent and no mask."""
    conv_in = UNet3DConditionModel(NO_CONCAT.unet).conv_in.conv
    assert conv_in.weight.shape[1] == 4
    got, want = sample_both(spec_kw, cfg=NO_CONCAT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
