"""The port's frame-axis attention kernels against the JAX package's.

``followyourclick_tpu_torch.ops.temporal_attention``: the plain versions of
``temporal_attention`` and ``fused_temporal_block``, which the wrappers run
for CPU tensors, against the JAX Pallas kernels run in interpret mode (as
tests/test_temporal_attention.py runs them), against the JAX XLA attention
(``ops/attention._xla_attention``) and against the fp32 reference of the
block (``_fused_ref_fp32``). The same numpy inputs go to both; matrices are
transposed to the port's ``nn.Linear`` layout.

Tolerances as tests/test_torch_kernels.py: fp32 holds 2e-4 (rtol and atol),
since only the summation order differs; bf16 holds 3e-2 absolute at
unit-scale outputs, a few bf16 ulps, since both sides round at the same
points.

The kernels run only on an NVIDIA card: tests/test_torch_cuda.py compares
them with these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.ops import attention as jattn
from followyourclick_tpu.ops import temporal_attention as jta
from followyourclick_tpu_torch.ops.temporal_attention import (
    fused_temporal_block,
    temporal_attention,
    temporal_attention_ref,
    temporal_block_ref,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

FP32_TOL = 2e-4
BF16_ATOL = 3e-2


def _np(t):
    return np.array(t.float().numpy() if isinstance(t, torch.Tensor)
                    else jnp.asarray(t, jnp.float32), np.float32)


def _round(a, dtype):
    """numpy values as the dtype holds them (bf16-rounded for bf16)."""
    return _np(jnp.asarray(a, dtype))


def _close(got, want, dtype):
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("b,s,h,d", [(6, 16, 8, 40), (3, 16, 8, 160),
                                     (5, 4, 4, 8)])
def test_temporal_attention_matches_jax(jdt, tdt, b, s, h, d):
    rs = np.random.RandomState(b * s + d)
    q, k, v = (_round(rs.randn(b, s, h, d), jdt) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kernel = _np(jta.temporal_attention(jq, jk, jv, interpret=True))
    xla = _np(jattn._xla_attention(jq, jk, jv, None, d ** -0.5))
    got = _np(temporal_attention_ref(*(torch.from_numpy(a).to(tdt)
                                       for a in (q, k, v))))
    _close(got, kernel, jdt)
    _close(got, xla, jdt)


def _block_args(rs, b, f, c):
    """x (B, F, C); wq, wk, wv, wo in the JAX (in, out) layout; bo."""
    return ([rs.randn(b, f, c)]
            + [rs.randn(c, c) * c ** -0.5 for _ in range(3)]
            + [rs.randn(c, c) * 0.5 * c ** -0.5, 0.02 * rs.randn(c)])


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("b,f,c", [(6, 16, 320), (3, 16, 640)])
def test_temporal_block_matches_jax(jdt, tdt, b, f, c):
    heads = 8
    args = [_round(a, jdt) for a in _block_args(np.random.RandomState(c), b,
                                                f, c)]
    jargs = [jnp.asarray(a, jdt) for a in args]
    kernel = _np(jta.fused_temporal_block(*jargs, heads=heads,
                                          interpret=True))
    ref = _np(jta._fused_ref_fp32(*jargs, (c // heads) ** -0.5, heads))
    x, wq, wk, wv, wo, bo = (torch.from_numpy(a).to(tdt) for a in args)
    got = _np(temporal_block_ref(x, wq.T.contiguous(), wk.T.contiguous(),
                                 wv.T.contiguous(), wo.T.contiguous(), bo,
                                 heads=heads))
    _close(got, kernel, jdt)
    _close(got, ref, jdt)


def test_cpu_wrappers_are_the_plain_versions():
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(4, 16, 4, 8)).bfloat16()
               for _ in range(3))
    before = temporal_attention.launches
    torch.testing.assert_close(temporal_attention(q, k, v, 0.3),
                               temporal_attention_ref(q, k, v, 0.3),
                               rtol=0, atol=0)
    assert temporal_attention.launches == before
    args = [torch.from_numpy(a).float()
            for a in _block_args(rs, 3, 5, 32)]
    before = fused_temporal_block.launches
    torch.testing.assert_close(fused_temporal_block(*args, heads=4),
                               temporal_block_ref(*args, heads=4),
                               rtol=0, atol=0)
    assert fused_temporal_block.launches == before


def test_wrappers_raise_off_cpu_and_cuda():
    q = torch.empty(2, 16, 4, 8, device="meta")
    with pytest.raises(ValueError):
        temporal_attention(q, q, q)
    w = torch.empty(32, 32, device="meta")
    with pytest.raises(ValueError):
        fused_temporal_block(torch.empty(2, 16, 32, device="meta"), w, w, w,
                             w, torch.empty(32, device="meta"), heads=4)
