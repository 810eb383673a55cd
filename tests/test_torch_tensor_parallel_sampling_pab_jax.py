"""A ``pab488_deep4_cfg4_ex`` request (10 steps: PAB reuse, the DeepCache
trunk and the CFG cache over the sharded modules) on a ``(data, model) =
(2, 2)`` grid of ``gloo`` ranks against JAX's sampler on
``create_mesh(data=2, model=2)``, as the requests of
``tests/test_torch_tensor_parallel_sampling_jax.py`` (the same models,
draws, inputs and ``VIDEO_ATOL``), in a file of its own: JAX compiles this
schedule's sampler for most of a minute.
"""

import pytest

from tests.test_torch_tensor_parallel_sampling_jax import (
    check_request,
    run_both,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

NAMES = ("pab488_deep4_cfg4_ex",)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory, NAMES)


def test_grid_pab_request_equals_jax_sharded_sampler(both):
    check_request(both, 0, NAMES[0])
