"""The port's IP-Adapter on a served request: ``pab244_deep4_cfg4_ex`` at 10
steps against the JAX ``_sample_jit``, in the harness and tolerance of
``tests/test_torch_ip_adapter.py`` (a file of its own, so that the suite's
workers share the time)."""

import numpy as np
import pytest

from followyourclick_tpu.pipelines import serving_schedules as jss
from tests.test_torch_ip_adapter import EXACT, sample_both
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("spec_kw,b,plus", [
    ({**EXACT, "num_inference_steps": 10,
      **jss.SCHEDULES["pab244_deep4_cfg4_ex"]}, 1, False),
], ids=["pab244_deep4_cfg4_ex-vanilla"])
def test_tiny_ip_request_matches_jax(spec_kw, b, plus):
    """The serving schedule's cond-half steps slice ``context[b:]`` with the
    ip tokens included, as the JAX sampler does."""
    got, want = sample_both(spec_kw, b, plus)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
