"""The stages of the bf16 motion-block kernels, composed, against the plain
version of the whole block.

On the card, ``fused_motion_block`` in bf16 is eleven launches over the
frames-minor rows (R = P·F, C): per attention sublayer (a) LN + PE, (b) one
q/k/v product over the concatenated ``[Wq; Wk; Wv]``, (c) the frame
attention per position and head, (d) the out-projection with bias and
residual into the other residual buffer; then the LN-GEGLU feed-forward's
three. Their plain versions (``ops/motion_block.ln_pe_stage``,
``qkv_stage``, ``attention_stage``; ``ops/geglu.layer_norm_cast``,
``up_stage``, ``down_stage``), composed in that flow on the flat rows with
the PE table indexed by row % F, must give ``motion_block_ref`` bit for bit:
the launches round at the stage boundaries exactly where the Pallas kernel
rounds, so the split changes no numerics. ``motion_block_ref`` itself is
held against the Pallas kernel in interpret mode by
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.models.motion_module import (
    TemporalTransformerBlock,
)
from followyourclick_tpu_torch.ops.geglu import (
    down_stage,
    layer_norm_cast,
    up_stage,
)
from followyourclick_tpu_torch.ops.motion_block import (
    attention_stage,
    fits,
    fused_motion_block,
    ln_pe_stage,
    motion_block_ref,
    qkv_stage,
    qkv_weights,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

EPS = 1e-5


def _args(rs, p, f, c, dtype):
    def mk(shape, s, base=0.0):
        return torch.from_numpy((base + s * rs.randn(*shape)).astype(
            np.float32)).to(dtype)

    params = []
    for _ in range(2):
        params += [mk((c,), 0.05, 1.0), mk((c,), 0.05)] + [
            mk((c, c), c ** -0.5) for _ in range(4)] + [mk((c,), 0.02)]
    params += [mk((c,), 0.05, 1.0), mk((c,), 0.05),
               mk((8 * c, c), c ** -0.5), mk((8 * c,), 0.02),
               mk((c, 4 * c), (4 * c) ** -0.5), mk((c,), 0.02)]
    return mk((p, f, c), 1.0), mk((f, c), 0.5), params


def compose(x, pe, params, scale, heads, fast):
    """The bf16 wrapper's launch sequence, each launch by its plain
    version, on the flat (R, C) rows."""
    p, f, c = x.shape
    rows = p * f
    pe_rows = pe.repeat(p, 1)  # the LN pass adds pe[row % F]
    qkv = qkv_weights(params)
    h = x.reshape(rows, c)
    for i in range(2):
        ls, lb, _, _, _, wo, bo = params[7 * i:7 * i + 7]
        t = ln_pe_stage(h, ls, lb, pe_rows, EPS)                      # (a)
        q, k, v = qkv_stage(t, qkv[i])                                # (b)
        o = attention_stage(*(u.reshape(p, f, c) for u in (q, k, v)),
                            scale, heads).reshape(rows, c)            # (c)
        assert o.dtype == x.dtype and o.shape == (rows, c)
        h = down_stage(o, wo, bo, h)                                  # (d)
    lfs, lfb, w1, b1, w2, b2 = params[14:20]
    y = up_stage(layer_norm_cast(h, lfs, lfb, EPS), w1, b1, fast)
    assert y.shape == (rows, 4 * c)
    return down_stage(y, w2, b2, h).reshape(p, f, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("p,f,c,heads", [(3, 16, 64, 4), (5, 8, 128, 8),
                                         (3, 8, 128, 4), (5, 16, 64, 8)])
def test_stages_compose_to_motion_block_ref(dtype, fast, p, f, c, heads):
    x, pe, params = _args(np.random.RandomState(p * f + c), p, f, c, dtype)
    scale = (c // heads) ** -0.5
    got = compose(x, pe, params, scale, heads, fast)
    want = motion_block_ref(x, pe, params, scale, heads, eps=EPS,
                            fast_gating=fast)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_qkv_stage_is_the_three_products():
    x, _, params = _args(np.random.RandomState(1), 3, 8, 64, torch.bfloat16)
    wqkv = qkv_weights(params)[1]
    assert wqkv.shape == (192, 64)
    q, k, v = qkv_stage(x, wqkv)
    for got, w in zip((q, k, v), params[9:12]):
        assert torch.equal(got, torch.nn.functional.linear(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_the_plain_version(dtype):
    """On a CPU tensor the wrapper runs ``motion_block_ref`` and counts no
    launch, with or without the concatenated weights."""
    x, pe, params = _args(np.random.RandomState(4), 3, 8, 64, dtype)
    before = fused_motion_block.launches
    want = motion_block_ref(x, pe, params, 0.25, 4, fast_gating=True)
    for qkv in (None, qkv_weights(params)):
        got = fused_motion_block(x, pe, params, 0.25, 4, fast_gating=True,
                                 qkv=qkv)
        assert torch.equal(got, want)
    assert fused_motion_block.launches == before


def test_bf16_route_takes_every_path_width():
    """bf16 takes every width of the UNet (and the tiny configs') at up to
    32 frames; C must give 16-byte rows."""
    for c in (32, 64, 320, 640, 1280):
        assert fits(16, c, 8, torch.bfloat16)
    assert fits(32, 1280, 8, torch.bfloat16)
    assert not fits(33, 320, 8, torch.bfloat16)
    assert not fits(16, 36, 4, torch.bfloat16)
    assert not fits(16, 320, 8, torch.float16)


def test_module_builds_the_concatenation_once():
    """``TemporalTransformerBlock.qkv_weights`` is built once and rebuilt
    when a q/k/v weight is written."""
    torch.manual_seed(0)
    block = TemporalTransformerBlock(64, 4, 16)
    first = block.qkv_weights()
    assert all(a is b for a, b in zip(block.qkv_weights(), first))
    assert torch.equal(first[0], torch.cat([
        block.attention_blocks[0].to_q.weight,
        block.attention_blocks[0].to_k.weight,
        block.attention_blocks[0].to_v.weight]))
    with torch.no_grad():
        block.attention_blocks[1].to_v.weight.mul_(2.0)
    second = block.qkv_weights()
    assert second[1] is not first[1] and second[0] is first[0]
    assert torch.equal(second[1][128:], block.attention_blocks[1].to_v.weight)
