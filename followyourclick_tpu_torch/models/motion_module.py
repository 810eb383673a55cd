"""Temporal-attention motion modules.

Port of ``followyourclick_tpu/models/motion_module.py`` with sinusoidal PE.
On a CUDA tensor the standard block (two ``Temporal_Self`` attentions, no
RoPE or LoRA, full width ≤ 1280) runs as one launch of the hand-written
kernel (``ops/motion_block.fused_motion_block``); elsewhere the modular
``TemporalAttention`` path runs, as in the JAX package off the TPU. RoPE,
temporal LoRA, cross-attention blocks and the PAB sites are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from followyourclick_tpu_torch.config import MotionModuleConfig
from followyourclick_tpu_torch.models.attention import (
    GEGLUFeedForward,
    _ln_ff_residual,
)
from followyourclick_tpu_torch.models.layers import (
    GroupNorm,
    LayerNorm,
    temporal_positional_encoding,
)
from followyourclick_tpu_torch.ops.attention import dot_product_attention
from followyourclick_tpu_torch.ops.motion_block import fused_motion_block

_STANDARD = ("Temporal_Self", "Temporal_Self")


def _pe_table(enabled: bool, max_len: int, frames: int, dim: int,
              like: torch.Tensor) -> torch.Tensor:
    """(F, C) positional table in ``like``'s dtype (zeros when disabled)."""
    if not enabled:
        return torch.zeros(frames, dim, dtype=like.dtype, device=like.device)
    pe = temporal_positional_encoding(max_len, dim, device=like.device)
    return pe[0, :frames].to(like.dtype)


class TemporalAttention(nn.Module):
    """Self-attention along the frame axis of ``(B·H·W, F, C)`` rows, with
    the sinusoidal PE added to the (normed) input."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 temporal_position_encoding: bool = True,
                 temporal_position_encoding_max_len: int = 24):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.pe = temporal_position_encoding
        self.pe_max_len = temporal_position_encoding_max_len
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd, f, c = x.shape
        if self.pe:
            x = x + _pe_table(True, self.pe_max_len, f, c, x)

        def split(t):
            return t.reshape(bd, f, self.heads, self.dim_head)

        out = dot_product_attention(split(self.to_q(x)), split(self.to_k(x)),
                                    split(self.to_v(x)))
        return self.to_out(out.reshape(bd, f, -1).to(x.dtype))


class TemporalTransformerBlock(nn.Module):
    """Pre-LN temporal self-attentions with residuals, then LN → GEGLU FF."""

    def __init__(self, dim: int, num_attention_heads: int,
                 attention_head_dim: int,
                 attention_block_types: Sequence[str] = _STANDARD,
                 temporal_position_encoding: bool = True,
                 temporal_position_encoding_max_len: int = 24):
        super().__init__()
        if any(t != "Temporal_Self" for t in attention_block_types):
            raise NotImplementedError(
                f"attention_block_types {tuple(attention_block_types)}: "
                "only Temporal_Self is ported")
        self.dim = dim
        self.heads = num_attention_heads
        self.head_dim = attention_head_dim
        self.block_types = tuple(attention_block_types)
        self.pe = temporal_position_encoding
        self.pe_max_len = temporal_position_encoding_max_len
        self.norms = nn.ModuleList(LayerNorm(dim)
                                   for _ in attention_block_types)
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, num_attention_heads, attention_head_dim,
                              temporal_position_encoding,
                              temporal_position_encoding_max_len)
            for _ in attention_block_types)
        self.ff_norm = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def fused_params(self) -> tuple:
        """The kernel's 20 tensors, in ``fused_motion_block`` order."""
        out = []
        for norm, attn in zip(self.norms, self.attention_blocks):
            out += [norm.weight, norm.bias, attn.to_q.weight,
                    attn.to_k.weight, attn.to_v.weight, attn.to_out.weight,
                    attn.to_out.bias]
        return tuple(out) + (self.ff_norm.weight, self.ff_norm.bias,
                             self.ff.proj.weight, self.ff.proj.bias,
                             self.ff.out.weight, self.ff.out.bias)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        use_fused = (h.device.type == "cuda"
                     and self.block_types == _STANDARD
                     and self.heads * self.head_dim == self.dim
                     and self.dim <= 1280)
        if use_fused:
            pe = _pe_table(self.pe, self.pe_max_len, h.shape[1], self.dim, h)
            return fused_motion_block(h.contiguous(), pe, self.fused_params(),
                                      scale=self.head_dim ** -0.5,
                                      heads=self.heads)
        for norm, attn in zip(self.norms, self.attention_blocks):
            h = attn(norm(h)) + h
        return _ln_ff_residual(self.ff_norm, self.ff, h)


class MotionModule(nn.Module):
    """GroupNorm (per frame, 32 groups, eps 1e-6) → proj_in → blocks in the
    frames-minor ``(B·H·W, F, C)`` layout → proj_out → +residual."""

    def __init__(self, in_channels: int, config: MotionModuleConfig):
        super().__init__()
        if config.use_rope_position_encoding or config.add_temporal_lora:
            raise NotImplementedError(
                "RoPE and temporal LoRA are not ported yet")
        if config.temporal_attention_dim_div != 1:
            raise NotImplementedError("temporal_attention_dim_div != 1")
        c = in_channels
        self.norm = GroupNorm(c, 32, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(
                c, config.num_attention_heads,
                c // config.num_attention_heads,
                tuple(config.attention_block_types),
                config.temporal_position_encoding,
                config.temporal_position_encoding_max_len)
            for _ in range(config.num_transformer_block))
        self.proj_out = nn.Linear(c, c)
        if config.zero_initialize:
            nn.init.zeros_(self.proj_out.weight)
            nn.init.zeros_(self.proj_out.bias)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = hidden_states.shape
        residual = hidden_states.reshape(b * f, hh, ww, c)
        x = self.proj_in(self.norm(residual).reshape(b * f, hh * ww, c))
        x = x.reshape(b, f, hh * ww, c).permute(0, 2, 1, 3).reshape(
            b * hh * ww, f, c)
        for block in self.transformer_blocks:
            x = block(x)
        x = self.proj_out(x)
        x = x.reshape(b, hh * ww, f, c).permute(0, 2, 1, 3).reshape(
            b * f, hh, ww, c) + residual
        return x.reshape(b, f, hh, ww, c)
