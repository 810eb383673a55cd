"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere. The file
imports no JAX, so it runs on a machine without it; there, skip the suite's
conftest, which imports JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are unit normal, weights N(0, 1/fan_in), norm scales 1 + N(0, 0.05²).
The error is normalised: max |kernel - plain| / max |plain|. fp32 holds
1e-4: only the summation order differs. bf16, and the tanh gate in either
dtype (it rounds to bf16 inside), hold 1.6e-2, two bf16 ulps of the largest
output: both sides round to bf16 at the same points, but the plain version
rounds each product to bf16 before adding its fp32 bias and sums in another
order, so single values land an ulp or two apart; measured relative to each
value instead, a residual add that cancels (8 - 6) would magnify that ulp.
"""

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu, ln_geglu_ref
from followyourclick_tpu_torch.ops.motion_block import (
    fused_motion_block,
    motion_block_ref,
)

pytestmark = pytest.mark.cuda

FP32_REL = 1e-4
BF16_REL = 1.6e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _randn(rs, shape, s=1.0, dtype=torch.float32, device="cuda"):
    return torch.from_numpy((s * rs.randn(*shape)).astype(np.float32)).to(
        device, dtype)


def ln_geglu_args(rs, rows, c, dtype, device="cuda"):
    inner = 4 * c
    return [_randn(rs, (rows, c), 1.0, dtype, device),
            1.0 + _randn(rs, (c,), 0.05, dtype, device),
            _randn(rs, (c,), 0.05, dtype, device),
            _randn(rs, (2 * inner, c), c ** -0.5, dtype, device),
            _randn(rs, (2 * inner,), 0.02, dtype, device),
            _randn(rs, (c, inner), inner ** -0.5, dtype, device),
            _randn(rs, (c,), 0.02, dtype, device)]


def motion_block_args(rs, p, f, c, dtype, device="cuda"):
    def mk(shape, s):
        return _randn(rs, shape, s, dtype, device)

    vec, mat = (c,), (c, c)
    params = []
    for _ in range(2):
        params += [1.0 + mk(vec, 0.05), mk(vec, 0.05)] + [
            mk(mat, c ** -0.5) for _ in range(4)] + [mk(vec, 0.02)]
    params += [1.0 + mk(vec, 0.02), mk(vec, 0.02), mk((8 * c, c), c ** -0.5),
               mk((8 * c,), 0.02), mk((c, 4 * c), (4 * c) ** -0.5),
               mk(vec, 0.02)]
    return mk((p, f, c), 1.0), mk((f, c), 0.5), params


def assert_close(got, ref, bound):
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert float(err) <= bound, (float(err), bound)


def _bound(dtype, fast):
    return FP32_REL if dtype == torch.float32 and not fast else BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(77, 64), (1000, 320), (300, 1280)])
@pytest.mark.parametrize("fast", [False, True])
def test_ln_geglu_kernel_matches_plain(card, dtype, rows, c, fast):
    args = ln_geglu_args(np.random.RandomState(rows), rows, c, dtype)
    before = fused_ln_geglu.launches
    got = fused_ln_geglu(*args, fast_gating=fast).float()
    assert fused_ln_geglu.launches == before + 1
    ref = ln_geglu_ref(*args, fast_gating=fast).float()
    assert_close(got, ref, _bound(dtype, fast))


F32, BF16 = torch.float32, torch.bfloat16


# fp32 fits one block's shared memory up to C = 320 at 16 frames (the tiny
# configs and tests); the path's widths run in bf16
@pytest.mark.parametrize("dtype,p,f,c,heads", [
    (F32, 13, 16, 64, 4), (F32, 37, 5, 32, 4), (F32, 40, 16, 320, 8),
    (F32, 7, 24, 64, 4), (BF16, 13, 16, 64, 4), (BF16, 37, 5, 32, 4),
    (BF16, 40, 16, 320, 8), (BF16, 7, 24, 320, 8), (BF16, 9, 16, 640, 8)])
@pytest.mark.parametrize("fast", [False, True])
def test_motion_block_kernel_matches_plain(card, dtype, p, f, c, heads,
                                           fast):
    x, pe, params = motion_block_args(np.random.RandomState(p), p, f, c,
                                      dtype)
    scale = (c // heads) ** -0.5
    before = fused_motion_block.launches
    got = fused_motion_block(x, pe, params, scale, heads,
                             fast_gating=fast).float()
    assert fused_motion_block.launches == before + 1
    ref = motion_block_ref(x, pe, params, scale, heads,
                           fast_gating=fast).float()
    assert_close(got, ref, _bound(dtype, fast))


def test_motion_block_bf16_at_1280(card):
    x, pe, params = motion_block_args(np.random.RandomState(3), 8, 16, 1280,
                                      torch.bfloat16)
    got = fused_motion_block(x, pe, params, 160 ** -0.5, 8).float()
    ref = motion_block_ref(x, pe, params, 160 ** -0.5, 8).float()
    assert_close(got, ref, BF16_REL)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    args = ln_geglu_args(np.random.RandomState(0), 8, 64, torch.float32)
    with pytest.raises(ValueError):
        fused_ln_geglu(args[0].t(), *args[1:])          # not (R, C) rows
    with pytest.raises(TypeError):
        fused_ln_geglu(*[a.half() for a in args])       # no fp16 kernel
    x, pe, params = motion_block_args(np.random.RandomState(0), 4, 16, 640,
                                      torch.float32)
    with pytest.raises(ValueError):                     # fp32 at 640 does
        fused_motion_block(x, pe, params, 0.1, 8)       # not fit on chip
