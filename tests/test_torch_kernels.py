"""The port's two kernel modules against the JAX package's Pallas kernels.

``followyourclick_tpu_torch.ops.geglu`` (LN → GEGLU → residual) and
``ops.motion_block`` (the whole motion-module block): their plain PyTorch
versions, which a wrapper runs for CPU tensors, against the JAX kernels run
in interpret mode (as tests/test_geglu.py and tests/test_motion_block.py run
them) and against the JAX fp32 references ``_ln_ref_fp32`` / ``_ref_fp32``.
The same numpy inputs go to both; weights are transposed to the port's
``nn.Linear`` layout.

Tolerances: fp32 holds 2e-4 (rtol and atol), as the JAX kernel tests do,
since only the summation order differs. bf16 holds 3e-2 absolute at
unit-scale inputs and 0.08-scale weights: the JAX bf16 kernels themselves
land within about 3e-2 of their fp32 reference at these scales, and the two
bf16 implementations round at the same points, so they differ by a few bf16
ulps of the O(1) outputs.

The kernels themselves run only on an NVIDIA card: tests/test_torch_cuda.py
compares them with these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.ops import geglu as jgeglu
from followyourclick_tpu.ops import motion_block as jmb
from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu, ln_geglu_ref
from followyourclick_tpu_torch.ops.motion_block import (
    fused_motion_block,
    motion_block_ref,
)

FP32_TOL = 2e-4
BF16_ATOL = 3e-2
_MATS_MB = (2, 3, 4, 5, 9, 10, 11, 12, 16, 18)  # matrices of the 20-tuple


def _np(t):
    return np.array(t.float().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t, np.float32), np.float32)


def _ln_geglu_args(rs, rows, c, inner):
    return [rs.randn(rows, c).astype(np.float32),
            (1.0 + 0.05 * rs.randn(c)).astype(np.float32),
            (0.05 * rs.randn(c)).astype(np.float32),
            (0.08 * rs.randn(c, 2 * inner)).astype(np.float32),
            (0.02 * rs.randn(2 * inner)).astype(np.float32),
            (0.08 * rs.randn(inner, c)).astype(np.float32),
            (0.02 * rs.randn(c)).astype(np.float32)]


def _to_torch_ln_geglu(args, dtype):
    t = [torch.from_numpy(a) for a in args]
    t[3], t[5] = t[3].T.contiguous(), t[5].T.contiguous()
    return [a.to(dtype) for a in t]


@pytest.mark.parametrize("rows", [100, 77])
@pytest.mark.parametrize("residual", [True, False])
def test_ln_geglu_fp32_matches_jax(rows, residual):
    args = _ln_geglu_args(np.random.RandomState(rows), rows, 32, 128)
    ref = _np(jgeglu._ln_ref_fp32(*map(jnp.asarray, args), 1e-5, residual))
    jk = _np(jgeglu.fused_ln_geglu(*map(jnp.asarray, args), eps=1e-5,
                                   residual=residual, block_r=32,
                                   interpret=True))
    got = _np(ln_geglu_ref(*_to_torch_ln_geglu(args, torch.float32),
                           residual=residual, fast_gating=False))
    np.testing.assert_allclose(got, jk, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, ref, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("fast", [False, True])
def test_ln_geglu_bf16_matches_jax(fast):
    args = _ln_geglu_args(np.random.RandomState(3), 77, 32, 128)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jk = _np(jgeglu.fused_ln_geglu(*jargs, block_r=32, interpret=True,
                                   fast_gating=fast).astype(jnp.float32))
    ref = _np(jgeglu._ln_ref_fp32(*jargs, 1e-5, True))
    got = _np(ln_geglu_ref(*_to_torch_ln_geglu(
        [_np(a.astype(jnp.float32)) for a in jargs], torch.bfloat16),
        fast_gating=fast))
    np.testing.assert_allclose(got, jk, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=0)


def test_ln_geglu_cpu_wrapper_is_the_plain_version():
    args = _to_torch_ln_geglu(
        _ln_geglu_args(np.random.RandomState(5), 20, 32, 128),
        torch.bfloat16)
    before = fused_ln_geglu.launches
    got = fused_ln_geglu(*args)  # bf16 at C <= 640: tanh gating by default
    torch.testing.assert_close(got, ln_geglu_ref(*args, fast_gating=True),
                               rtol=0, atol=0)
    assert fused_ln_geglu.launches == before  # the plain version is no launch


def _mb_args(rs, p, f, c):
    inner = 4 * c

    def mk(shape, s=0.08):
        return (s * rs.randn(*shape)).astype(np.float32)

    params = [1.0 + mk((c,), 0.05), mk((c,), 0.05), mk((c, c)), mk((c, c)),
              mk((c, c)), mk((c, c)), mk((c,), 0.02),
              1.0 + mk((c,), 0.05), mk((c,), 0.03), mk((c, c)), mk((c, c)),
              mk((c, c)), mk((c, c)), mk((c,), 0.02),
              1.0 + mk((c,), 0.02), mk((c,), 0.02), mk((c, 2 * inner)),
              mk((2 * inner,), 0.02), mk((inner, c)), mk((c,), 0.02)]
    x = rs.randn(p, f, c).astype(np.float32)
    pe = (0.1 * rs.randn(f, c)).astype(np.float32)
    return x, pe, params


def _to_torch_params(params, dtype):
    out = []
    for i, a in enumerate(params):
        t = torch.from_numpy(np.asarray(a, np.float32))
        out.append((t.T.contiguous() if i in _MATS_MB else t).to(dtype))
    return out


@pytest.mark.parametrize("p,f", [(12, 5), (7, 4)])
def test_motion_block_fp32_matches_jax(p, f):
    c, heads = 32, 4
    x, pe, params = _mb_args(np.random.RandomState(p), p, f, c)
    scale = (c // heads) ** -0.5
    jp = tuple(map(jnp.asarray, params))
    jk = _np(jmb.fused_motion_block(jnp.asarray(x), jnp.asarray(pe), jp,
                                    scale, heads, block_b=4,
                                    interpret=True))
    ref = _np(jmb._ref_fp32(jnp.asarray(x), jnp.asarray(pe), jp, scale,
                            heads, 1e-5))
    got = _np(motion_block_ref(torch.from_numpy(x), torch.from_numpy(pe),
                               _to_torch_params(params, torch.float32),
                               scale, heads, fast_gating=False))
    np.testing.assert_allclose(got, jk, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, ref, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("fast", [False, True])
def test_motion_block_bf16_matches_jax(fast):
    p, f, c, heads = 9, 4, 32, 4
    x, pe, params = _mb_args(np.random.RandomState(11), p, f, c)
    scale = (c // heads) ** -0.5
    bf = jnp.bfloat16
    jp = tuple(jnp.asarray(a, bf) for a in params)
    jx, jpe = jnp.asarray(x, bf), jnp.asarray(pe, bf)
    jk = _np(jmb.fused_motion_block(jx, jpe, jp, scale, heads, block_b=4,
                                    fast_gating=fast, interpret=True
                                    ).astype(jnp.float32))
    ref = _np(jmb._ref_fp32(jx, jpe, jp, scale, heads, 1e-5))
    got = _np(motion_block_ref(
        torch.from_numpy(_np(jx.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(_np(jpe.astype(jnp.float32))).bfloat16(),
        _to_torch_params([_np(a.astype(jnp.float32)) for a in jp],
                         torch.bfloat16),
        scale, heads, fast_gating=fast))
    np.testing.assert_allclose(got, jk, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=0)


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError):
        fused_ln_geglu(x, *[torch.empty(1, device="meta")] * 6)
    with pytest.raises(ValueError):
        fused_motion_block(torch.empty(2, 4, 32, device="meta"),
                           torch.empty(4, 32, device="meta"),
                           [torch.empty(1, device="meta")] * 20, 0.5, 4)

