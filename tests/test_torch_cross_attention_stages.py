"""The stages of the bf16 ``fused_ln_cross_attention``, composed, against the
plain version of the whole call.

On the card, ``fused_ln_cross_attention`` in bf16 is four launches over the
rows (R = B·S, C): (a) the LN pass, (b) ``q = xn·Wqᵀ`` on the GEMM core, (c)
the short-kv attention per batch row and head, (d) the out-projection with
its bias and no residual; k and v are projected by the wrapper. Their plain
versions (``ops/geglu.layer_norm_cast``, ``ops/cross_attention.q_stage``,
``attention_stage``, ``ops/geglu.down_stage`` with ``residual=None``),
composed in that flow on the flat rows, must give ``ln_cross_attention_ref``
bit for bit in bf16 and fp32: the launches round at the stage boundaries
exactly where the Pallas kernel casts, so the split changes no numerics.
``ln_cross_attention_ref`` itself is held against the Pallas kernel in
interpret mode by tests/test_torch_unrouted_kernels.py.
"""

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.ops.cross_attention import (
    attention_smem,
    attention_stage,
    fused_ln_cross_attention,
    ln_cross_attention_ref,
    project_kv,
    q_stage,
)
from followyourclick_tpu_torch.ops.geglu import down_stage, layer_norm_cast
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

HEADS = 8
CTX = 96  # context channels (the model's is 768)


def _args(rs, b, s, c, skv, dtype):
    def mk(shape, scale, base=0.0):
        return torch.from_numpy((base + scale * rs.randn(*shape)).astype(
            np.float32)).to(dtype)

    return [mk((b, s, c), 1.0), mk((b, skv, CTX), 1.0),
            mk((c,), 0.05, 1.0), mk((c,), 0.05),
            mk((c, c), c ** -0.5), mk((c, CTX), CTX ** -0.5),
            mk((c, CTX), CTX ** -0.5), mk((c, c), c ** -0.5),
            mk((c,), 0.02)]


def compose(x, context, ls, lb, wq, wk, wv, wo, bo, heads, scale, eps=1e-5):
    """The bf16 wrapper's launch sequence, each launch by its plain version,
    on the flat (R, C) rows."""
    b, s, c = x.shape
    rows = b * s
    k, v = project_kv(context, wk, wv)
    xn = layer_norm_cast(x.reshape(rows, c), ls, lb, eps)           # (a)
    q = q_stage(xn, wq)                                             # (b)
    o = attention_stage(q.reshape(b, s, -1), k, v, heads, scale)    # (c)
    assert o.dtype == x.dtype and o.shape == (b, s, wq.shape[0])
    return down_stage(o.reshape(rows, -1), wo, bo, None).reshape(b, s, c)


# D = C / 8 heads: 40, 80 and 160 (the model's three widths); Skv 1, 77 (the
# text context) and 128 (the most the kernel takes); S = 333 lies off the
# attention's 128-row tile and the GEMM core's
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("skv", [1, 77, 128])
def test_stages_compose_to_ln_cross_attention_ref(dtype, d, skv):
    c = HEADS * d
    args = _args(np.random.RandomState(d + skv), 2, 333, c, skv, dtype)
    scale = d ** -0.5
    got = compose(*args, HEADS, scale)
    want = ln_cross_attention_ref(*args, heads=HEADS, scale=scale)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_the_plain_version(dtype):
    """On a CPU tensor the wrapper runs ``ln_cross_attention_ref`` (default
    scale ``D^-0.5``) and counts no launch."""
    args = _args(np.random.RandomState(3), 3, 50, 320, 77, dtype)
    before = fused_ln_cross_attention.launches
    got = fused_ln_cross_attention(*args, heads=HEADS)
    assert torch.equal(got, ln_cross_attention_ref(*args, heads=HEADS,
                                                   scale=40 ** -0.5))
    assert fused_ln_cross_attention.launches == before


def test_attention_stage_masks_nothing_but_the_keys_it_is_given():
    """Attention over one key returns that key's values in every row."""
    rs = np.random.RandomState(5)
    q = torch.from_numpy(rs.randn(2, 7, 16).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(2, 1, 16).astype(np.float32))
            for _ in range(2))
    o = attention_stage(q, k, v, heads=2, scale=0.3)
    assert torch.equal(o, v.expand(2, 7, 16))


@pytest.mark.parametrize("d,skv,want", [(40, 77, (16 + 160) * 56 * 2),
                                        (160, 128, (16 + 256) * 168 * 2),
                                        (16, 1, (16 + 32) * 24 * 2)])
def test_attention_smem_is_the_smallest_tile(d, skv, want):
    """One head of 16 query rows and Skv keys rounded up to 16, each row
    ``round16(D) + 8`` bf16 (an odd multiple of 16 bytes)."""
    assert attention_smem(d, skv) == want
