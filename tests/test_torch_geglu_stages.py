"""The three stages of the bf16 LN-GEGLU kernels, composed, against the
plain versions of the whole feed-forward.

On the card, ``fused_ln_geglu`` in bf16 is three launches (LN, the
up-projection with the gate in its epilogue, the down-projection with the
bias and residual in its epilogue), and ``fused_geglu`` the last two. Their
plain versions (``ops/geglu.layer_norm_cast``, ``up_stage``,
``down_stage``) must compose to ``ln_geglu_ref`` / ``geglu_ref`` bit for
bit: the kernels round at the stage boundaries exactly where the one-kernel
form rounds, so the split changes no numerics. ``ln_geglu_ref`` itself is held against the
Pallas kernel in interpret mode by tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.ops.geglu import (
    down_stage,
    fused_geglu,
    fused_ln_geglu,
    geglu_ref,
    layer_norm_cast,
    ln_geglu_ref,
    up_stage,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def _args(rs, rows, c, dtype):
    inner = 4 * c

    def mk(shape, s, base=0.0):
        return torch.from_numpy((base + s * rs.randn(*shape)).astype(
            np.float32)).to(dtype)

    return [mk((rows, c), 1.0), mk((c,), 0.05, 1.0), mk((c,), 0.05),
            mk((2 * inner, c), c ** -0.5), mk((2 * inner,), 0.02),
            mk((c, inner), inner ** -0.5), mk((c,), 0.02)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,c", [(77, 32), (40, 64), (130, 40)])
def test_stages_compose_to_ln_geglu_ref(dtype, fast, residual, rows, c):
    x, ls, lb, w1, b1, w2, b2 = _args(np.random.RandomState(rows + c), rows,
                                      c, dtype)
    y = up_stage(layer_norm_cast(x, ls, lb, 1e-5), w1, b1, fast)
    assert y.dtype == dtype and y.shape == (rows, 4 * c)
    got = down_stage(y, w2, b2, x if residual else None)
    want = ln_geglu_ref(x, ls, lb, w1, b1, w2, b2, eps=1e-5,
                        residual=residual, fast_gating=fast)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
def test_stages_compose_to_geglu_ref(dtype, fast):
    x, _, _, w1, b1, w2, b2 = _args(np.random.RandomState(7), 50, 32, dtype)
    got = down_stage(up_stage(x, w1, b1, fast), w2, b2)
    assert torch.equal(got, geglu_ref(x, w1, b1, w2, b2, fast_gating=fast))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_take_the_plain_versions(dtype):
    """On a CPU tensor the wrappers run the plain versions and count no
    launch."""
    x, ls, lb, w1, b1, w2, b2 = _args(np.random.RandomState(3), 20, 32, dtype)
    before = (fused_ln_geglu.launches, fused_geglu.launches)
    got = fused_ln_geglu(x, ls, lb, w1, b1, w2, b2, fast_gating=False)
    xn = layer_norm_cast(x, ls, lb, 1e-5)
    assert torch.equal(got, down_stage(up_stage(xn, w1, b1, False), w2, b2,
                                       x))
    got = fused_geglu(x, w1, b1, w2, b2, fast_gating=True)
    assert torch.equal(got, down_stage(up_stage(x, w1, b1, True), w2, b2))
    assert (fused_ln_geglu.launches, fused_geglu.launches) == before
