"""Temporal rotary position embedding for frame-axis attention.

Port of ``followyourclick_tpu/models/rope.py``: LLaMA-style rotate-half RoPE,
the NTK-aware base ``base·α^(d/(d-2))``, and the log-scaled query
``q·log(train_len)/log(video_len)`` when a clip has more frames than the
motion module was trained on.
"""

from __future__ import annotations

import math

import torch


def rope_tables(dim: int, length: int, base: float = 10000.0,
                ntk_alpha: float = 0.0, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos / sin tables of shape ``(length, dim)``, the frequencies
    duplicated (LLaMA layout)."""
    if ntk_alpha:
        base = base * ntk_alpha ** (dim / (dim - 2))
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, train_video_length: int = 16,
               video_length: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k, whose last two axes broadcast against the ``(F, D)``
    tables, in fp32; q is scaled by ``log(train) / log(F)`` when F exceeds
    ``train_video_length``. Each comes back in its own dtype."""
    q_rot = q * cos + _rotate_half(q) * sin
    k_rot = k * cos + _rotate_half(k) * sin
    if video_length is None:
        video_length = q.shape[-2]
    if video_length > train_video_length:
        q_rot = q_rot * (math.log(train_video_length)
                         / math.log(video_length))
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
