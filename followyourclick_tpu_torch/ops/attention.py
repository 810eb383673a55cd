"""Attention dispatch over ``(B, S, H, D)`` tensors.

Port of ``followyourclick_tpu/ops/attention.py::dot_product_attention`` and
its routing rules (``:141-221``), written out as :func:`route`, a function of
the shapes alone:

- "tiny": ``sq == sk ≤ 32`` and ``sq·h ≤ 256``, no bias: the hand-written
  kernel ``ops/temporal_attention.temporal_attention``;
- "flash": ``sk ≥ 1024``, no bias, and above 12 GiB of bf16 scores
  (``b·h·sq·sk·2``): the hand-written kernel
  ``ops/flash_attention.flash_attention`` (level-0 spatial self-attention of
  a 2-clip CFG request at 16 frames, 512²);
- "plain": everything else, PyTorch's ``scaled_dot_product_attention`` in
  the role the JAX package gives XLA (the softmax runs in fp32 in its
  kernels); with a bias (CLIP's causal mask, T5's position bias and
  padding mask) the JAX formula itself, fp32 logits plus the fp32 bias.

``impl`` is the JAX argument: "auto" routes as above, "flash" takes the
flash route whenever there is no bias, "xla" the plain route, "packed" the
JAX head-packed tiny-sequence formulation (:func:`packed_small_seq_attention`,
plain PyTorch, bias included, since the JAX one is no Pallas kernel). Under
"auto" the kernel routes apply on a CUDA tensor, and a CPU tensor takes the
plain route, as the JAX package does off the TPU; "flash" asked for by name
runs ``flash_attention`` on either, which on a CPU tensor is its plain
version ``flash_attention_ref``.

Training's memory lever (JAX ``_batch_chunked_attention``, read from
``FYC_ATTN_BATCH_CHUNK``): on the plain route without a bias, with a batch
divisible by and larger than the chunk and more than 256 MiB of fp32
scores, attention runs ``chunk`` batch rows at a time
(:class:`BatchChunkedAttention`), and its backward recomputes each chunk
from q, k and v; the rows are independent, so the result is exact.

Mixed dtypes (``upcast_attention``: q and k in fp32, v in bf16) compute what
the JAX plain path computes: fp32 logits and weights times v promoted, so v
is cast up (exactly) and the route's kernel runs in fp32.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops.flash_attention import flash_attention
from followyourclick_tpu_torch.ops.temporal_attention import (
    temporal_attention,
)

FLASH_SCORE_BYTES = 12 * 1024 ** 3
IMPLS = ("auto", "flash", "xla", "packed")


def route(query_shape, key_shape, has_bias: bool,
          impl: str = "auto") -> str:
    """"tiny", "flash", "plain" or "packed" for ``(B, Sq, H, D)`` q and
    ``(B, Sk, H, D)`` k on the card."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl == "packed":
        return "packed"
    if has_bias or impl == "xla":
        return "plain"
    if impl == "flash":
        return "flash"
    b, sq, h, _ = query_shape
    sk = key_shape[1]
    if sq == sk and sq <= 32 and sq * h <= 256:
        return "tiny"
    if sk >= 1024 and b * h * sq * sk * 2 > FLASH_SCORE_BYTES:
        return "flash"
    return "plain"


def packed_small_seq_attention(query: torch.Tensor, key: torch.Tensor,
                               value: torch.Tensor,
                               bias: Optional[torch.Tensor],
                               scale: float) -> torch.Tensor:
    """Block-diagonal head packing for tiny self-attention (the frame
    axis): (frame, head) packed into one axis of S·H, cross-head logits
    masked to -1e9, one fp32-accumulated product each way (JAX
    ``ops/attention.py::_packed_small_seq_attention``). ``bias`` broadcasts
    to ``(B, H, S, S)``."""
    b, s, h, d = query.shape
    m = s * h
    qp, kp, vp = (t.reshape(b, m, d) for t in (query, key, value))
    logits = torch.einsum("bmd,bnd->bmn", qp.float(), kp.float()) * scale
    idx = torch.arange(m, device=query.device)
    head, frame = idx % h, idx // h
    if bias is not None:
        bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
        bias = bias.expand(bias.shape[0], h, s, s)
        packed = bias[:, head[:, None], frame[:, None], frame[None, :]]
        logits = logits + packed.float()
    logits = logits.masked_fill(head[:, None] != head[None, :], -1e9)
    weights = torch.softmax(logits, dim=-1).to(query.dtype)
    return torch.einsum("bmn,bnd->bmd", weights, vp).reshape(b, s, h, d)


def _plain_attention(query, key, value, bias, scale):
    if bias is not None:
        # the JAX plain path: fp32 logits plus the fp32 bias, the weights
        # cast to q's dtype (the bias never rounds to bf16)
        logits = torch.einsum("bqhd,bkhd->bhqk", query.float(),
                              key.float()) * scale + bias.float()
        weights = torch.softmax(logits, dim=-1).to(query.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, value)
    out = F.scaled_dot_product_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        scale=scale)
    return out.transpose(1, 2)


CHUNK_SCORE_BYTES = 256 * 1024 ** 2


class BatchChunkedAttention(torch.autograd.Function):
    """Plain attention ``chunk`` batch rows at a time; the backward saves
    only q, k, v and recomputes each chunk's attention to differentiate
    it (JAX ``ops/attention.py::_chunked_bwd``)."""

    @staticmethod
    def forward(ctx, query, key, value, scale, chunk):
        ctx.scale, ctx.chunk = scale, chunk
        ctx.save_for_backward(query, key, value)
        return torch.cat([_plain_attention(query[i:i + chunk],
                                           key[i:i + chunk],
                                           value[i:i + chunk], None, scale)
                          for i in range(0, query.shape[0], chunk)])

    @staticmethod
    def backward(ctx, grad):
        query, key, value = ctx.saved_tensors
        chunk = ctx.chunk
        grads = ([], [], [])
        for i in range(0, query.shape[0], chunk):
            with torch.enable_grad():
                ins = [t[i:i + chunk].detach().requires_grad_()
                       for t in (query, key, value)]
                out = _plain_attention(*ins, None, ctx.scale)
                for acc, g in zip(grads, torch.autograd.grad(
                        out, ins, grad[i:i + chunk])):
                    acc.append(g)
        return (*(torch.cat(g) for g in grads), None, None)


def batch_chunk(query_shape, key_shape, has_bias: bool) -> int:
    """The chunk ``FYC_ATTN_BATCH_CHUNK`` asks for at this site, or 0 where
    the JAX conditions do not hold."""
    chunk = int(os.environ.get("FYC_ATTN_BATCH_CHUNK", "0"))
    b, sq, h, _ = query_shape
    if (chunk > 0 and not has_bias and b % chunk == 0 and b > chunk
            and b * h * sq * key_shape[1] * 4 > CHUNK_SCORE_BYTES):
        return chunk
    return 0


def dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Multi-head attention; ``bias`` is additive and broadcasts to
    ``(B, H, Sq, Sk)``. Returns ``(B, Sq, H, D)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    dtype = torch.promote_types(torch.promote_types(query.dtype, key.dtype),
                                value.dtype)
    query, key, value = (t.to(dtype) for t in (query, key, value))
    kind = route(query.shape, key.shape, bias is not None, impl)
    if kind == "packed":
        return packed_small_seq_attention(query, key, value, bias, scale)
    if kind == "flash" and (impl == "flash" or query.device.type == "cuda"):
        return flash_attention(query, key, value, scale)
    if kind == "tiny" and query.device.type == "cuda":
        return temporal_attention(query, key, value, scale)
    chunk = batch_chunk(query.shape, key.shape, bias is not None)
    if chunk:
        return BatchChunkedAttention.apply(query, key, value, scale, chunk)
    return _plain_attention(query, key, value, bias, scale)
