"""The port's tiny T5 sampler under the serving schedule
``pab244_deep4_cfg4_ex`` (one period of 4 and the 2 final exact steps)
against the JAX ``_sample_jit``: the T5 cross-attention's PAB site
``attn_t5_out`` (kind cross) is recorded and reused as the JAX sampler does.
The harness and the 1e-3 tolerance are those of
``tests/test_torch_pipeline_t5.py``.
"""

import numpy as np

from followyourclick_tpu.pipelines.serving_schedules import SCHEDULES
from tests.test_torch_pipeline import EXACT
from tests.test_torch_pipeline_t5 import T5_CFG, sample_both
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def test_tiny_t5_serving_sample_matches_jax():
    spec_kw = dict(EXACT, num_inference_steps=6,
                   **SCHEDULES["pab244_deep4_cfg4_ex"])
    got, want, *_ = sample_both(T5_CFG, spec_kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
