"""The port's ``utils/profiling.block_until_ready``: it walks tensors in
lists, tuples and dicts and gives its argument back. The tracer of the same
module is tested in ``tests/test_torch_tracing.py``.
"""

import torch

from followyourclick_tpu_torch.utils import profiling as tprof
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def test_block_until_ready_walks_containers():
    out = {"x": torch.ones(2), "y": [torch.zeros(1), (torch.ones(3),)],
           "z": 4}
    assert tprof.block_until_ready(out) is out
    t = torch.ones(2)
    assert tprof.block_until_ready(t) is t
