"""The kernels' gradients against the JAX package's ``custom_vjp`` backward
passes.

Each wrapper reached under autograd with an input that requires grad goes
through its ``torch.autograd.Function`` (``ops/autograd.Recompute`` and
``ops/flash_attention.FlashAttentionGrad``); on a CPU tensor its forward is
the plain version and its backward the fp32 recompute the card runs too.
The same numpy inputs and cotangent go to the port's Function and to
``jax.vjp`` of the JAX wrapper run with ``interpret=True`` (the unrouted
GroupNorm and LN-cross-attention too; flash under
``pltpu.force_tpu_interpret_mode``; its backward is the same recompute);
fp32 gradients must agree within 1e-5 of the largest magnitude of each JAX
gradient. The batch-chunked attention (the
``FYC_ATTN_BATCH_CHUNK`` lever) is held to the JAX one the same way.
The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from followyourclick_tpu.ops import attention as jattn
from followyourclick_tpu.ops import cross_attention as jca
from followyourclick_tpu.ops import flash_attention as jfa
from followyourclick_tpu.ops import geglu as jgeglu
from followyourclick_tpu.ops import groupnorm as jgn
from followyourclick_tpu.ops import motion_block as jmb
from followyourclick_tpu.ops import temporal_attention as jta
from followyourclick_tpu_torch.ops import attention as tattn
from followyourclick_tpu_torch.ops.cross_attention import (
    fused_ln_cross_attention,
)
from followyourclick_tpu_torch.ops.flash_attention import flash_attention
from followyourclick_tpu_torch.ops.geglu import fused_geglu, fused_ln_geglu
from followyourclick_tpu_torch.ops.groupnorm import fused_group_norm
from followyourclick_tpu_torch.ops.motion_block import fused_motion_block
from followyourclick_tpu_torch.ops.temporal_attention import (
    fused_temporal_block,
    temporal_attention,
)
from tests.test_torch_kernels import _ln_geglu_args, _mb_args, _MATS_MB
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TOL = 1e-5


def port_grads(fn, args, cot, transpose=()):
    """Gradients of ``fn(*args)`` against ``cot`` through the port, each
    back in the JAX layout (``transpose``: indices of nn.Linear matrices)."""
    ts = [torch.tensor(a.T if i in transpose else a, requires_grad=True)
          for i, a in enumerate(args)]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return [t.grad.numpy().T if i in transpose else t.grad.numpy()
            for i, t in enumerate(ts)], out


def jax_grads(fn, args, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))], out


def close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1e-30))


def test_motion_block_grad():
    p, f, c, heads = 7, 5, 32, 4
    rs = np.random.RandomState(0)
    x, pe, params = _mb_args(rs, p, f, c)
    cot = rs.randn(p, f, c).astype(np.float32)
    scale = (c // heads) ** -0.5
    got, out = port_grads(
        lambda x, pe, *ps: fused_motion_block(x, pe, ps, scale, heads),
        [x, pe, *params], cot, transpose={i + 2 for i in _MATS_MB})
    assert type(out.grad_fn).__name__ == "MotionBlockGradBackward"
    want, _ = jax_grads(
        lambda x, pe, *ps: jmb.fused_motion_block(x, pe, ps, scale, heads,
                                                  block_b=4, interpret=True),
        [x, pe, *params], cot)
    close(got, want)


@pytest.mark.parametrize("residual", [True, False])
def test_ln_geglu_grad(residual):
    rs = np.random.RandomState(1)
    args = _ln_geglu_args(rs, 45, 32, 64)
    cot = rs.randn(45, 32).astype(np.float32)
    got, out = port_grads(
        functools.partial(fused_ln_geglu, residual=residual), args, cot,
        transpose={3, 5})
    assert type(out.grad_fn).__name__ == "LnGegluGradBackward"
    want, _ = jax_grads(
        lambda *a: jgeglu.fused_ln_geglu(*a, residual=residual, block_r=16,
                                         interpret=True), args, cot)
    close(got, want)


def test_geglu_grad():
    rs = np.random.RandomState(2)
    x, _, _, w1, b1, w2, b2 = _ln_geglu_args(rs, 40, 32, 64)
    args = [x, w1, b1, w2, b2]
    cot = rs.randn(40, 32).astype(np.float32)
    got, out = port_grads(fused_geglu, args, cot, transpose={1, 3})
    assert type(out.grad_fn).__name__ == "GegluGradBackward"
    want, _ = jax_grads(
        lambda *a: jgeglu.fused_geglu(*a, block_r=16, interpret=True), args,
        cot)
    close(got, want)


def test_temporal_attention_grad():
    rs = np.random.RandomState(3)
    q, k, v, cot = (rs.randn(6, 16, 4, 8).astype(np.float32)
                    for _ in range(4))
    got, out = port_grads(temporal_attention, [q, k, v], cot)
    assert type(out.grad_fn).__name__ == "TemporalAttentionGradBackward"
    want, _ = jax_grads(
        lambda *a: jta.temporal_attention(*a, interpret=True), [q, k, v],
        cot)
    close(got, want)


def test_temporal_block_grad():
    b, s, c, heads = 5, 16, 32, 4
    rs = np.random.RandomState(4)
    x = rs.randn(b, s, c).astype(np.float32)
    ws = [(0.15 * rs.randn(c, c)).astype(np.float32) for _ in range(4)]
    bo = (0.02 * rs.randn(c)).astype(np.float32)
    cot = rs.randn(b, s, c).astype(np.float32)
    got, out = port_grads(
        lambda *a: fused_temporal_block(*a, heads=heads), [x, *ws, bo], cot,
        transpose={1, 2, 3, 4})
    assert type(out.grad_fn).__name__ == "TemporalBlockGradBackward"
    want, _ = jax_grads(
        lambda *a: jta.fused_temporal_block(*a, heads=heads, interpret=True),
        [x, *ws, bo], cot)
    close(got, want)


@pytest.mark.parametrize("sq,sk", [(40, 40), (24, 56)])
def test_flash_attention_grad(sq, sk):
    rs = np.random.RandomState(sq)
    q = rs.randn(2, sq, 3, 8).astype(np.float32)
    k, v = (rs.randn(2, sk, 3, 8).astype(np.float32) for _ in range(2))
    cot = rs.randn(2, sq, 3, 8).astype(np.float32)
    got, out = port_grads(flash_attention, [q, k, v], cot)
    assert type(out.grad_fn).__name__ == "FlashAttentionGradBackward"
    with pltpu.force_tpu_interpret_mode():
        want, _ = jax_grads(
            lambda *a: jfa.flash_attention(*a, block_q=16, block_k=16),
            [q, k, v], cot)
    close(got, want)


def test_flash_grad_chunks_rows(monkeypatch):
    """The backward's chunks over B·H rows give the unchunked result."""
    from followyourclick_tpu_torch.ops import flash_attention as tfa

    rs = np.random.RandomState(7)
    q, k, v, cot = (rs.randn(3, 20, 2, 8).astype(np.float32)
                    for _ in range(4))
    whole, _ = port_grads(flash_attention, [q, k, v], cot)
    monkeypatch.setattr(tfa, "REF_CHUNK_BYTES", 20 * 20 * 4 * 2)
    chunked, _ = port_grads(flash_attention, [q, k, v], cot)
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_no_grad_keeps_the_plain_route():
    """Without grad the wrappers return the plain version's tensor, no
    autograd node."""
    rs = np.random.RandomState(5)
    q = torch.from_numpy(rs.randn(2, 8, 2, 8).astype(np.float32))
    assert temporal_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert temporal_attention(qg, qg, qg).grad_fn is None


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_grad(act):
    b, n, c, groups = 2, 24, 32, 8
    rs = np.random.RandomState(8)
    x = (1.5 + rs.randn(b, n, c)).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    cot = rs.randn(b, n, c).astype(np.float32)
    got, out = port_grads(
        lambda *a: fused_group_norm(*a, groups=groups, act=act),
        [x, scale, bias], cot)
    assert type(out.grad_fn).__name__ == "GroupNormGradBackward"
    want, _ = jax_grads(
        lambda *a: jgn.fused_group_norm(*a, groups=groups, act=act,
                                        interpret=True), [x, scale, bias],
        cot)
    close(got, want)


@pytest.mark.parametrize("skv", [7, 77])
def test_cross_attention_grad(skv):
    b, s, c, ck, heads, d = 2, 20, 32, 24, 4, 8
    rs = np.random.RandomState(skv)
    x = rs.randn(b, s, c).astype(np.float32)
    ctx = rs.randn(b, skv, ck).astype(np.float32)
    ls = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    lb = (0.1 * rs.randn(c)).astype(np.float32)
    wq = (rs.randn(c, heads * d) * c ** -0.5).astype(np.float32)
    wk, wv = ((rs.randn(ck, heads * d) * ck ** -0.5).astype(np.float32)
              for _ in range(2))
    wo = (rs.randn(heads * d, c) * (heads * d) ** -0.5).astype(np.float32)
    bo = (0.02 * rs.randn(c)).astype(np.float32)
    args = [x, ctx, ls, lb, wq, wk, wv, wo, bo]
    cot = rs.randn(b, s, c).astype(np.float32)
    got, out = port_grads(
        lambda *a: fused_ln_cross_attention(*a, heads=heads), args, cot,
        transpose={4, 5, 6, 7})
    assert type(out.grad_fn).__name__ == "LnCrossAttentionGradBackward"
    want, _ = jax_grads(
        lambda *a: jca.fused_ln_cross_attention(*a, heads=heads, block_s=8,
                                                interpret=True), args, cot)
    close(got, want)


def test_batch_chunked_attention(monkeypatch):
    """``FYC_ATTN_BATCH_CHUNK``: the site's batch in chunks, forward and
    gradients as the JAX ``_batch_chunked_attention`` (the score-size
    condition lowered to reach it at a small shape)."""
    monkeypatch.setenv("FYC_ATTN_BATCH_CHUNK", "2")
    monkeypatch.setattr(tattn, "CHUNK_SCORE_BYTES", 0)
    rs = np.random.RandomState(6)
    q, k, v, cot = (rs.randn(6, 20, 2, 8).astype(np.float32)
                    for _ in range(4))
    scale = 8 ** -0.5
    got, out = port_grads(
        lambda *a: tattn.dot_product_attention(*a, impl="xla"), [q, k, v],
        cot)
    assert type(out.grad_fn).__name__ == "BatchChunkedAttentionBackward"
    want, jout = jax_grads(
        lambda *a: jattn._batch_chunked_attention(*a, scale, 2), [q, k, v],
        cot)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=TOL)
    close(got, want)


def test_batch_chunk_conditions(monkeypatch):
    """The JAX conditions: no bias, a batch divisible by and larger than
    the chunk, more than 256 MiB of fp32 scores."""
    monkeypatch.setenv("FYC_ATTN_BATCH_CHUNK", "8")
    big = (24, 1792, 8, 40)  # level-0 self-attention, 24 frames, 448x256
    assert tattn.batch_chunk(big, big, False) == 8
    assert tattn.batch_chunk(big, big, True) == 0
    assert tattn.batch_chunk((20, 1792, 8, 40), big, False) == 0
    assert tattn.batch_chunk((8, 1792, 8, 40), big, False) == 0
    assert tattn.batch_chunk((24, 77, 8, 40), (24, 77, 8, 40), False) == 0
    monkeypatch.delenv("FYC_ATTN_BATCH_CHUNK")
    assert tattn.batch_chunk(big, big, False) == 0
