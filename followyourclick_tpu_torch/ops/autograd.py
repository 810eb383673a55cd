"""Gradients through the hand-written kernels.

Each Pallas kernel of the JAX package carries a ``jax.custom_vjp`` whose
backward is plain fp32 math: it recomputes the function in fp32 from the
saved inputs and differentiates that (``ops/motion_block.py::_block_bwd``,
``ops/geglu.py::_ln_geglu_bwd`` and ``_geglu_bwd``,
``ops/temporal_attention.py::_attn_bwd`` and ``_fused_vjp_bwd``,
``ops/flash_attention.py::_flash_vjp_bwd``). :class:`Recompute` is that
pattern as a ``torch.autograd.Function``: the forward runs the wrapper's
route (the kernel on a CUDA tensor, the plain version on a CPU one) and
saves its tensor inputs as they are, never the kernel's intermediates; the
backward runs the wrapper's fp32 reference under autograd and casts each
gradient back to its input's dtype. The kernels' launches therefore carry
no backward kernel, as in the JAX package.

A wrapper reached under ``torch.enable_grad()`` with an input that requires
grad goes through its subclass of :class:`Recompute` (one per wrapper, so a
profiler names each backward); a kernel without one raises there
(:func:`refuse_grad`) rather than hand back a tensor autograd cannot see
through.
"""

from __future__ import annotations

import torch


class Recompute(torch.autograd.Function):
    """``apply(run, reference, *tensors)``: ``run(*tensors)`` forward;
    gradients of ``reference(*fp32 copies)`` backward."""

    @staticmethod
    def forward(ctx, run, reference, *tensors):
        ctx.reference = reference
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, grad):
        tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(n)
                      for t, n in zip(tensors, needs)]
            want = [leaf for leaf, n in zip(leaves, needs) if n]
            got = iter(torch.autograd.grad(
                ctx.reference(*leaves), want, grad.float(),
                allow_unused=True))
        out = []
        for t, n in zip(tensors, needs):
            g = next(got) if n else None
            if n and g is None:
                g = torch.zeros_like(t)
            out.append(None if g is None else g.to(t.dtype))
        return (None, None, *out)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors`` here."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel that has no backward is reached under grad."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; call it outside autograd "
            "(torch.no_grad) or use its plain version")
