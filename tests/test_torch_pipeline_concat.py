"""The port's tiny sampler over a UNet with
``use_first_frame_condition_concat`` (the first-frame latent concatenated on
every frame inside the UNet, ``conv_in`` 4 + 4 channels, halved after it)
and no click-mask channels, against the JAX ``_sample_jit``: the pipeline
hands the first-frame latent to the UNet as ``reference_images_latent``.
The harness and the 1e-3 tolerance are those of
``tests/test_torch_pipeline_t5.py``.
"""

import numpy as np

from tests.test_torch_pipeline import EXACT
from tests.test_torch_pipeline_t5 import CONCAT_CFG, sample_both


def test_tiny_first_frame_concat_sample_matches_jax():
    got, want, pipe, *_ = sample_both(CONCAT_CFG, EXACT)
    assert pipe.unet.conv_in.conv.in_channels == 8
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
