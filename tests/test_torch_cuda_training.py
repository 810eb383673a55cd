"""Gradients through the port's kernels on an NVIDIA card.

These tests need the card and skip elsewhere; the file imports no JAX (run
it with ``--noconftest``, as
``tests/test_torch_cuda.py``). A bf16 motion module whose blocks take the
whole-block kernel, under autograd: the gradients of its parameters through
the kernels' autograd Functions are non-zero and match those through the
plain versions (the wrappers swapped by ``chip_smoke.wrappers_replaced``)
to a cosine of 0.99 each; the two kernels without a backward raise under
grad on the card.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_motion_module_grads_through_kernels(card):
    import chip_smoke
    from followyourclick_tpu_torch.config import MotionModuleConfig
    from followyourclick_tpu_torch.models.motion_module import MotionModule
    from followyourclick_tpu_torch.ops.motion_block import fused_motion_block

    torch.manual_seed(0)
    mm = MotionModule(320, MotionModuleConfig(zero_initialize=False)).to(
        card, torch.bfloat16)
    x = torch.randn(1, 16, 12, 10, 320, device=card, dtype=torch.bfloat16)
    cot = torch.randn_like(x)
    params = dict(mm.named_parameters())

    def grads():
        out = mm(x)
        return dict(zip(params, torch.autograd.grad(
            out, list(params.values()), cot)))

    launches = fused_motion_block.launches
    got = grads()
    assert fused_motion_block.launches == launches + 1
    plain = chip_smoke.plain_versions()
    with chip_smoke.wrappers_replaced(lambda name, fn: plain[name]):
        want = grads()
    assert fused_motion_block.launches == launches + 1
    for name, g in got.items():
        a, b = g.double().flatten(), want[name].double().flatten()
        assert bool(a.any()), name
        cos = float(a @ b) / float(a.norm() * b.norm())
        assert cos >= 0.99, (name, cos)


def test_unported_backward_raises(card):
    from followyourclick_tpu_torch.ops.cross_attention import (
        fused_ln_cross_attention,
    )
    from followyourclick_tpu_torch.ops.groupnorm import fused_group_norm

    bf = torch.bfloat16
    x = torch.randn(2, 64, 320, device=card, dtype=bf, requires_grad=True)
    scale = torch.ones(320, device=card, dtype=bf)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_group_norm(x, scale, torch.zeros_like(scale), 32)
    with torch.no_grad():
        assert fused_group_norm(x, scale, torch.zeros_like(scale),
                                32).shape == x.shape
    ctx = torch.randn(2, 77, 768, device=card, dtype=bf)
    w = [torch.randn(320, 320, device=card, dtype=bf) * 0.05,
         torch.randn(320, 768, device=card, dtype=bf) * 0.05,
         torch.randn(320, 768, device=card, dtype=bf) * 0.05,
         torch.randn(320, 320, device=card, dtype=bf) * 0.05]
    with pytest.raises(RuntimeError, match="no backward"):
        fused_ln_cross_attention(x, ctx, scale, torch.zeros_like(scale), *w,
                                 torch.zeros_like(scale), heads=8)
