"""Tensor parallelism over the ``model`` axis of a mesh (Megatron's f and g).

The JAX package shards the attention and feed-forward weights over the
``model`` axis of its mesh (``parallel/sharding.py``) and leaves the
collectives to GSPMD. Here each rank holds its slice of those weights
(``parallel/sharding.shard_params``) and the modules call two
``torch.autograd.Function``s where the activations cross from the
replicated region into the rank's own and back:

- :func:`copy_to_model` (Megatron's f): the identity forward, an
  all-reduce of the gradient backward. It stands before every product
  with a weight split on its output dimension (column-parallel: q, k, v,
  the GEGLU in-projection), and before each replicated weight that a rank
  uses only in part (the temporal LoRA), so the gradient of the replicated
  tensor is the sum of the ranks' parts on every rank;
- :func:`reduce_from_model` (Megatron's g): an all-reduce forward, the
  identity backward. It closes every product with a weight split on its
  input dimension (row-parallel: the attention's out-projection, the GEGLU
  out-projection, the VAE's ``proj_attn``, the VAE attention's logits).

The partial sums are all-reduced in fp32 and cast afterwards, whatever the
working dtype: each rank's partial product is rounded once to that dtype,
as the one-process product is, and the sum of the ranks' parts is not
rounded again before the bias.

Under gloo a CUDA tensor is staged through page-locked host memory (gloo
has no device transport); NCCL reduces on the card. A mesh whose
``model`` axis has one rank makes every call here the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A copy of the CUDA tensor ``t`` in page-locked host memory (from
    PyTorch's caching host allocator), gloo's staging buffer: faster to
    copy to and from the card than pageable memory (``chip_smoke.py``'s
    phase 24 times both)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place (staged through the
    host for a CUDA tensor under gloo); returns ``t``. Counts its calls
    and the bytes it reduces (``all_reduce_sum_.calls``, ``.bytes``)."""
    import torch.distributed as dist

    all_reduce_sum_.calls += 1
    all_reduce_sum_.bytes += t.numel() * t.element_size()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = _pinned(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


all_reduce_sum_.calls = 0
all_reduce_sum_.bytes = 0


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (of one shape) over ``group``, in rank order, on
    ``t``'s device (staged through the host for a CUDA tensor under
    gloo)."""
    import torch.distributed as dist

    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = _pinned(t) if staged else t
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    """A new fp32 tensor: the sum of the ranks' ``x``."""
    y = x.float().contiguous()
    return all_reduce_sum_(y.clone() if y is x else y, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """f: ``x`` as it is; its gradient summed over the model ranks."""
    if mesh is None or mesh.model_group is None:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """g: the fp32 sum of the model ranks' ``x``; the gradient passes as
    it is."""
    if mesh is None or mesh.model_group is None:
        return x.float()
    return _ReduceFromModel.apply(x, mesh.model_group)


def column_linear(x: torch.Tensor, linear: torch.nn.Linear,
                  mesh) -> torch.Tensor:
    """The rank's output columns of ``linear`` (its weight and bias already
    this rank's rows) of the replicated ``x``. Where several products read
    one ``x`` (q, k, v) the modules pass it through :func:`copy_to_model`
    once and call the linears themselves."""
    return linear(copy_to_model(x, mesh))


def row_linear(x: torch.Tensor, linear: torch.nn.Linear, mesh,
               extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W.T + b`` for ``x`` of this rank's input columns and ``W``
    this rank's columns of the weight: the partial product (plus
    ``extra``, another partial sum of the same output) summed over the
    model ranks in fp32, the bias added once, cast to ``x``'s dtype."""
    partial = F.linear(x, linear.weight)
    if extra is not None:
        partial = partial + extra
    out = reduce_from_model(partial, mesh)
    if linear.bias is not None:
        out = out + linear.bias.float()
    return out.to(x.dtype)


def rank_slice(w: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's contiguous share of the replicated ``w`` along
    ``dim``, behind :func:`copy_to_model`: the gradient of ``w`` is the sum
    of every rank's part, the same on every rank."""
    n = w.shape[dim] // mesh.model_size
    return copy_to_model(w, mesh).narrow(dim, mesh.model_rank * n, n)
