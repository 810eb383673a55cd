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
  kernels).

``impl`` is the JAX argument: "auto" routes as above, "flash" takes the
flash route whenever there is no bias, "xla" the plain route. "packed" (the
JAX head-packed tiny-sequence formulation) is not ported and raises. Under
"auto" the kernel routes apply on a CUDA tensor, and a CPU tensor takes the
plain route, as the JAX package does off the TPU; "flash" asked for by name
runs ``flash_attention`` on either, which on a CPU tensor is its plain
version ``flash_attention_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops.flash_attention import flash_attention
from followyourclick_tpu_torch.ops.temporal_attention import (
    temporal_attention,
)

FLASH_SCORE_BYTES = 12 * 1024 ** 3
IMPLS = ("auto", "flash", "xla")


def route(query_shape, key_shape, has_bias: bool,
          impl: str = "auto") -> str:
    """"tiny", "flash" or "plain" for ``(B, Sq, H, D)`` q and
    ``(B, Sk, H, D)`` k on the card."""
    if impl == "packed":
        raise NotImplementedError(
            "impl='packed' (the JAX head-packed tiny-sequence attention) is "
            "not ported")
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
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


def _plain_attention(query, key, value, bias, scale):
    out = F.scaled_dot_product_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        attn_mask=None if bias is None else bias.to(query.dtype),
        scale=scale)
    return out.transpose(1, 2)


def dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Multi-head attention; ``bias`` is additive and broadcasts to
    ``(B, H, Sq, Sk)``. Returns ``(B, Sq, H, D)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    kind = route(query.shape, key.shape, bias is not None, impl)
    if kind == "flash" and (impl == "flash" or query.device.type == "cuda"):
        return flash_attention(query, key, value, scale)
    if kind == "tiny" and query.device.type == "cuda":
        return temporal_attention(query, key, value, scale)
    return _plain_attention(query, key, value, bias, scale)
