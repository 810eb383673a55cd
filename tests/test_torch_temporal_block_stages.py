"""The stages of the bf16 ``fused_temporal_block``, composed, against the
plain version of the whole block.

On the card, ``fused_temporal_block`` in bf16 is three launches over the
rows (R = B·S, C): (b) one q/k/v product over the concatenated ``[Wq; Wk;
Wv]``, (c) the frame attention per position and head, (d) the
out-projection with its bias and no residual. Their plain versions
(``ops/motion_block.qkv_stage``, ``attention_stage``;
``ops/geglu.down_stage`` with ``residual=None``), composed in that flow on
the flat rows, must give ``temporal_block_ref`` bit for bit in bf16 and
fp32: the launches round at the stage boundaries exactly where the Pallas
kernel rounds, so the split changes no numerics. ``temporal_block_ref``
itself is held against the Pallas kernel in interpret mode by
tests/test_torch_temporal_attention.py.
"""

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.models.motion_module import TemporalAttention
from followyourclick_tpu_torch.ops.geglu import down_stage
from followyourclick_tpu_torch.ops.motion_block import (
    attention_stage,
    qkv_stage,
)
from followyourclick_tpu_torch.ops.temporal_attention import (
    fused_temporal_block,
    temporal_block_ref,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def _args(rs, b, s, c, dtype):
    def mk(shape, scale):
        return torch.from_numpy((scale * rs.randn(*shape)).astype(
            np.float32)).to(dtype)

    return [mk((b, s, c), 1.0)] + [mk((c, c), c ** -0.5)
                                   for _ in range(4)] + [mk((c,), 0.02)]


def compose(x, wq, wk, wv, wo, bo, scale, heads):
    """The bf16 wrapper's launch sequence, each launch by its plain
    version, on the flat (R, C) rows."""
    b, s, c = x.shape
    rows = b * s
    q, k, v = qkv_stage(x.reshape(rows, c), torch.cat((wq, wk, wv)))  # (b)
    o = attention_stage(*(u.reshape(b, s, c) for u in (q, k, v)), scale,
                        heads).reshape(rows, c)                       # (c)
    assert o.dtype == x.dtype and o.shape == (rows, c)
    return down_stage(o, wo, bo, None).reshape(b, s, c)               # (d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c,heads", [(3, 16, 64, 4), (5, 8, 128, 8),
                                         (2, 5, 64, 4)])
def test_stages_compose_to_temporal_block_ref(dtype, b, s, c, heads):
    args = _args(np.random.RandomState(b * s + c), b, s, c, dtype)
    scale = (c // heads) ** -0.5
    got = compose(*args, scale, heads)
    want = temporal_block_ref(*args, scale=scale, heads=heads)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_the_plain_version(dtype):
    """On a CPU tensor the wrapper runs ``temporal_block_ref`` and counts no
    launch, with or without the concatenated weight."""
    args = _args(np.random.RandomState(4), 3, 16, 64, dtype)
    before = fused_temporal_block.launches
    want = temporal_block_ref(*args, scale=0.3, heads=4)
    for qkv in (None, torch.cat(args[1:4])):
        got = fused_temporal_block(*args, scale=0.3, heads=4, qkv=qkv)
        assert torch.equal(got, want)
    assert fused_temporal_block.launches == before


def test_module_builds_the_concatenation_once():
    """``TemporalAttention.qkv_weight`` is built once and rebuilt when a
    q/k/v weight is written in place or replaced."""
    torch.manual_seed(0)
    attn = TemporalAttention(64, 4, 16)
    first = attn.qkv_weight()
    assert first.shape == (192, 64)
    assert attn.qkv_weight() is first
    assert torch.equal(first, torch.cat([attn.to_q.weight, attn.to_k.weight,
                                         attn.to_v.weight]))
    with torch.no_grad():
        attn.to_k.weight.mul_(2.0)
    second = attn.qkv_weight()
    assert second is not first
    assert attn.qkv_weight() is second
    assert torch.equal(second[64:128], attn.to_k.weight)
    attn.to(torch.bfloat16)
    third = attn.qkv_weight()
    assert third.dtype == torch.bfloat16
    assert torch.equal(third[128:], attn.to_v.weight)


def test_module_on_the_cpu_is_the_plain_block():
    """The module's forward on the CPU (plain q/k/v products and the
    tiny-sequence attention) agrees with the block's plain version on the
    input plus the PE."""
    torch.manual_seed(1)
    attn = TemporalAttention(64, 4, 16, temporal_position_encoding=False)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 16, 64).astype(
        np.float32))
    with torch.no_grad():
        got = attn(x)
        want = temporal_block_ref(
            x, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
            attn.to_out.weight, attn.to_out.bias, scale=16 ** -0.5, heads=4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
