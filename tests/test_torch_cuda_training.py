"""Gradients through the port's kernels on an NVIDIA card.

These tests need the card and skip elsewhere; the file imports no JAX (run
it with ``--noconftest``, as
``tests/test_torch_cuda.py``). A bf16 motion module whose blocks take the
whole-block kernel, under autograd: the gradients of its parameters through
the kernels' autograd Functions are non-zero and match those through the
plain versions (the wrappers swapped by ``chip_smoke.wrappers_replaced``)
to a cosine of 0.99 each; the two unrouted kernels of the UNet's sites
(GroupNorm, LN-cross-attention) give their plain versions' gradients under
autograd, their forward launches counted as before.
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


def test_unrouted_kernels_backward(card):
    """GroupNorm + SiLU and LN-cross-attention at a 320-wide UNet site,
    bf16: gradients through their Functions against autograd through the
    plain versions in fp32, cosine 0.99 each; one forward launch each."""
    from followyourclick_tpu_torch.ops.cross_attention import (
        fused_ln_cross_attention,
        ln_cross_attention_ref,
    )
    from followyourclick_tpu_torch.ops.groupnorm import (
        fused_group_norm,
        group_norm_ref,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(0)

    def leaf(shape, s=1.0, base=0.0):
        return (base + s * torch.randn(shape, generator=gen, device=card)
                ).to(bf).requires_grad_()

    def check(route, plain, leaves, out_shape):
        cot = torch.randn(out_shape, generator=gen, device=card).to(bf)
        got = torch.autograd.grad(route(*leaves), leaves, cot)
        ref = [t.detach().float().requires_grad_() for t in leaves]
        want = torch.autograd.grad(plain(*ref), ref, cot.float())
        for g, w in zip(got, want):
            a, b = g.double().flatten(), w.double().flatten()
            assert bool(a.any()) and g.dtype == bf
            assert float(a @ b) / float(a.norm() * b.norm()) >= 0.99

    gn = [leaf((2, 4096, 320), 1.0, 2.0), leaf((320,), 0.05, 1.0),
          leaf((320,), 0.05)]
    before = fused_group_norm.launches
    check(lambda *a: fused_group_norm(*a, 32, 1e-5, "silu"),
          lambda *a: group_norm_ref(*a, 32, 1e-5, "silu"), gn,
          (2, 4096, 320))
    assert fused_group_norm.launches == before + 1
    ca = [leaf((2, 4096, 320)), leaf((2, 77, 768)), leaf((320,), 0.05, 1.0),
          leaf((320,), 0.05), leaf((320, 320), 320 ** -0.5),
          leaf((320, 768), 768 ** -0.5), leaf((320, 768), 768 ** -0.5),
          leaf((320, 320), 320 ** -0.5), leaf((320,), 0.02)]
    before = fused_ln_cross_attention.launches
    check(lambda *a: fused_ln_cross_attention(*a, heads=8),
          lambda *a: ln_cross_attention_ref(*a, heads=8), ca,
          (2, 4096, 320))
    assert fused_ln_cross_attention.launches == before + 1
