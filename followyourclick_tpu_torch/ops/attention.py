"""Attention dispatch over ``(B, S, H, D)`` tensors.

Port of ``followyourclick_tpu/ops/attention.py::dot_product_attention`` and
its routing rules (``:141-221``). The JAX package sends three kinds of call
to three places:

- tiny sequences (``sq == sk ≤ 32`` and ``sq·h ≤ 256``) to the Pallas kernel
  ``ops/temporal_attention.py::temporal_attention``;
- score sets above 12 GiB of bf16 to ``ops/flash_attention.py``;
- everything else to XLA.

The port's plain route takes the XLA role: PyTorch's
``scaled_dot_product_attention`` (the softmax runs in fp32 in its kernels).
The two Pallas routes are not ported yet (ROADMAP.md, Queue 2), so a CUDA
tensor that would take one of them raises ``NotImplementedError`` rather than
quietly taking the plain route. A CPU tensor always takes the plain route, as
the JAX package does off the TPU. Neither route is reached by the exact
click-to-video sampler at 16 frames and 512²: its temporal attention runs
inside the fused motion block, and its largest score set is 8.6 GB.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

FLASH_SCORE_BYTES = 12 * 1024 ** 3


def _plain_attention(query, key, value, bias, scale):
    out = F.scaled_dot_product_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        attn_mask=None if bias is None else bias.to(query.dtype),
        scale=scale)
    return out.transpose(1, 2)


def dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention; ``bias`` is additive and broadcasts to
    ``(B, H, Sq, Sk)``. Returns ``(B, Sq, H, D)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    b, sq, h, _ = query.shape
    sk = key.shape[1]
    if query.device.type == "cuda" and bias is None:
        if sq == sk and sq <= 32 and sq * h <= 256:
            raise NotImplementedError(
                "tiny-sequence attention (the JAX package's "
                "ops/temporal_attention.py::temporal_attention route) has no "
                "Hopper kernel yet: ROADMAP.md, Queue 2, temporal_attention")
        if sk >= 1024 and b * h * sq * sk * 2 > FLASH_SCORE_BYTES:
            raise NotImplementedError(
                "attention above 12 GiB of scores (the JAX package's "
                "ops/flash_attention.py route) has no Hopper kernel yet: "
                "ROADMAP.md, Queue 2, flash_attention")
    return _plain_attention(query, key, value, bias, scale)
