"""Spatial transformer blocks (self-attention → text cross-attention → FF).

Port of ``followyourclick_tpu/models/attention.py`` on the exact path: the
IP-Adapter keys, the T5 cross-attention, cross-frame and in-block temporal
attention and the PAB sites are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.models.layers import GroupNorm, LayerNorm
from followyourclick_tpu_torch.ops.attention import dot_product_attention
from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu


class CrossAttention(nn.Module):
    """q/k/v projections (no bias) → multi-head attention → out projection."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, hidden_states: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                attention_bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if context is None:
            context = hidden_states
        b, s, _ = hidden_states.shape

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads,
                             self.dim_head)

        out = dot_product_attention(split(self.to_q(hidden_states)),
                                    split(self.to_k(context)),
                                    split(self.to_v(context)),
                                    bias=attention_bias)
        return self.to_out(out.reshape(b, s, -1).to(hidden_states.dtype))


class GEGLUFeedForward(nn.Module):
    """proj to 2·(mult·dim) → h · gelu(gate) (exact erf) → out. The plain
    path of :func:`_ln_ff_residual`."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = nn.Linear(dim, 2 * inner)
        self.out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate, approximate="none"))


def _ln_ff_residual(norm: LayerNorm, ff: GEGLUFeedForward,
                    h: torch.Tensor) -> torch.Tensor:
    """LayerNorm → GEGLU FF → +h. On a CUDA tensor this is one launch of the
    hand-written kernel (ops/geglu.fused_ln_geglu); elsewhere the modular
    path, as the JAX package runs it off the TPU."""
    if h.device.type == "cuda":
        out = fused_ln_geglu(h.reshape(-1, h.shape[-1]), norm.weight,
                             norm.bias, ff.proj.weight, ff.proj.bias,
                             ff.out.weight, ff.out.bias, eps=norm.eps,
                             residual=True)
        return out.reshape(h.shape)
    return ff(norm(h)) + h


class BasicTransformerBlock(nn.Module):
    """self-attention → text cross-attention → GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, num_attention_heads: int,
                 attention_head_dim: int, cross_attention_dim: int = 768):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, num_attention_heads,
                                    attention_head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, num_attention_heads,
                                    attention_head_dim, cross_attention_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, hidden_states: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        h = self.attn1(self.norm1(hidden_states)) + hidden_states
        # CFG prefix sharing (exact): hidden states at the pre-CFG batch meet
        # context at the doubled [uncond; cond] batch. The halves were equal
        # up to here; duplicate where text conditioning first enters.
        if context.shape[0] != h.shape[0]:
            tile = context.shape[0] // h.shape[0]
            assert tile * h.shape[0] == context.shape[0], \
                (h.shape, context.shape)
            h = torch.cat([h] * tile, dim=0)
        h = self.attn2(self.norm2(h), context) + h
        return _ln_ff_residual(self.norm3, self.ff, h)


class SpatialTransformer3D(nn.Module):
    """GroupNorm (per frame) → proj_in → blocks → proj_out → +residual, frames
    folded into the batch."""

    def __init__(self, in_channels: int, num_attention_heads: int,
                 attention_head_dim: int, num_layers: int = 1,
                 cross_attention_dim: int = 768, norm_num_groups: int = 32):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.norm = GroupNorm(in_channels, norm_num_groups, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, num_attention_heads,
                                  attention_head_dim, cross_attention_dim)
            for _ in range(num_layers))
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = hidden_states.shape
        residual = hidden_states.reshape(b * f, hh, ww, c)
        x = self.norm(residual).reshape(b * f, hh * ww, c)
        x = self.proj_in(x)
        ctx = context.repeat_interleave(f, dim=0)
        for block in self.transformer_blocks:
            x = block(x, ctx)
        bf_out = x.shape[0]  # CFG-doubled inside the first block when shared
        x = self.proj_out(x).reshape(bf_out, hh, ww, c)
        if bf_out != residual.shape[0]:
            residual = torch.cat([residual] * (bf_out // residual.shape[0]))
        return (x + residual).reshape(bf_out // f, f, hh, ww, c)
