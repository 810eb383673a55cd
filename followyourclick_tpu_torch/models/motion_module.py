"""Temporal-attention motion modules.

Port of ``followyourclick_tpu/models/motion_module.py``: sinusoidal PE or
RoPE (``models/rope.py``), the temporal LoRA on q, k, v and out
(``add_temporal_lora``, scaled by ``lora_scale``), ``_Cross`` block types,
``temporal_attention_dim_div`` (head width C / heads / div, so q, k, v and
the out-projection's input are C / div wide) and the temporal PAB sites
(``attn_0_out``, ``attn_1_out``). The UNet calls a motion module with no
context, so a ``_Cross`` attention falls back to its own input, as in the
JAX package (``motion_module.py:140-144``): a second self-attention over the
frames.

Routes on a CUDA tensor, decided before any launch, as the JAX rules:

- the whole-block kernel ``ops/motion_block.fused_motion_block`` takes a
  standard block (two ``Temporal_Self`` attentions, no RoPE, no LoRA, inner
  width = C ≤ 1280) when no PAB mode records or reuses temporal sites and
  the kernel takes this width, frame count and dtype
  (``ops/motion_block.fits``: bf16 at every width of 16-byte rows; fp32
  where one position's block fits a thread block's shared memory, which
  C ≥ 640 does not);
- every other block takes the modular path, each attention through a PAB
  site: one call of ``ops/temporal_attention.fused_temporal_block`` for an
  attention without RoPE or LoRA, inner width = C < 1280 (in bf16 with the
  module's cached ``[Wq; Wk; Wv]``), else the q/k/v products and
  ``dot_product_attention``, whose tiny-sequence route (F ≤ 32) launches
  ``temporal_attention``; its FF is ``ops/geglu.fused_ln_geglu``.

The fit test is a deliberate route, not a recovery from a failed build or
launch. On a CPU tensor the modular path runs with plain PyTorch, as the JAX
package runs off the TPU.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

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
from followyourclick_tpu_torch.models.pab import PabMode, pab_site
from followyourclick_tpu_torch.models.rope import apply_rope, rope_tables
from followyourclick_tpu_torch.ops import motion_block
from followyourclick_tpu_torch.ops.attention import dot_product_attention
from followyourclick_tpu_torch.ops.motion_block import fused_motion_block
from followyourclick_tpu_torch.ops.temporal_attention import (
    fused_temporal_block,
)

_STANDARD = ("Temporal_Self", "Temporal_Self")


def _pe_table(enabled: bool, max_len: int, frames: int, dim: int,
              like: torch.Tensor) -> torch.Tensor:
    """(F, C) positional table in ``like``'s dtype (zeros when disabled)."""
    if not enabled:
        return torch.zeros(frames, dim, dtype=like.dtype, device=like.device)
    pe = temporal_positional_encoding(max_len, dim, device=like.device)
    return pe[0, :frames].to(like.dtype)


class LoRADense(nn.Module):
    """Rank-``rank`` residual projection ``up(down(x))``: down N(0, 1/rank²),
    up zero, so a fresh one adds nothing (JAX ``LoRADense``)."""

    def __init__(self, in_features: int, features: int, rank: int = 4):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, features, bias=False)
        nn.init.normal_(self.down.weight, std=1.0 / rank)
        nn.init.zeros_(self.up.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(self.down(x))


class TemporalAttention(nn.Module):
    """Self-attention along the frame axis of ``(B·H·W, F, C)`` rows, with
    the sinusoidal PE added to the (normed) input or RoPE on q and k, and
    the temporal LoRA (``add_temporal_lora``) beside each projection."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 temporal_position_encoding: bool = True,
                 temporal_position_encoding_max_len: int = 24,
                 use_rope: bool = False, train_video_length: int = 16,
                 add_temporal_lora: bool = False, lora_rank: int = 4):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.pe = temporal_position_encoding
        self.pe_max_len = temporal_position_encoding_max_len
        self.use_rope = use_rope
        self.train_video_length = train_video_length
        self.lora = add_temporal_lora
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)
        if add_temporal_lora:
            self.to_q_lora = LoRADense(query_dim, inner, lora_rank)
            self.to_k_lora = LoRADense(query_dim, inner, lora_rank)
            self.to_v_lora = LoRADense(query_dim, inner, lora_rank)
            self.to_out_lora = LoRADense(inner, query_dim, lora_rank)
        self._qkv_key, self._qkv = None, None

    def qkv_weight(self) -> torch.Tensor:
        """``[Wq; Wk; Wv]`` of shape ``(3C, C)``, the operand of the bf16
        block's q/k/v product (a forward input only, outside autograd),
        built once and again only when one of those weights changes: another
        tensor object (a train step's cast, a ``functional_call``; held by
        weak reference, so a new tensor at a freed one's address is not
        taken for it) or an in-place write (``_version``)."""
        ws = (self.to_q.weight, self.to_k.weight, self.to_v.weight)
        with torch.no_grad():
            key = tuple((w._version, w.data_ptr()) for w in ws)
            held = self._qkv_key is not None and all(
                ref() is w for ref, w in zip(self._qkv_key[0], ws))
            if not held or key != self._qkv_key[1]:
                self._qkv = torch.cat(ws)
                self._qkv_key = (tuple(weakref.ref(w) for w in ws), key)
        return self._qkv

    def fused_route(self, c: int) -> bool:
        """The JAX rule for ``fused_temporal_block``: no LoRA, no RoPE, inner
        width = C < 1280 (on a CUDA tensor)."""
        return (not self.lora and not self.use_rope
                and self.heads * self.dim_head == c and c < 1280)

    def forward(self, x: torch.Tensor,
                lora_scale: float = 1.0) -> torch.Tensor:
        bd, f, c = x.shape
        if self.pe and not self.use_rope:
            x = x + _pe_table(True, self.pe_max_len, f, c, x)
        if x.device.type == "cuda" and self.fused_route(c):
            return fused_temporal_block(
                x.contiguous(), self.to_q.weight, self.to_k.weight,
                self.to_v.weight, self.to_out.weight, self.to_out.bias,
                scale=self.dim_head ** -0.5, heads=self.heads,
                qkv=self.qkv_weight() if x.dtype == torch.bfloat16
                else None)

        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.lora:
            q = q + lora_scale * self.to_q_lora(x)
            k = k + lora_scale * self.to_k_lora(x)
            v = v + lora_scale * self.to_v_lora(x)

        def split(t):
            return t.reshape(bd, f, self.heads, self.dim_head)

        q, k, v = split(q), split(k), split(v)
        if self.use_rope:
            cos, sin = rope_tables(self.dim_head, f, device=x.device)
            # (F, D) tables against (B·D, F, H, Dh): broadcast over heads
            q, k = apply_rope(q, k, cos[:, None], sin[:, None],
                              self.train_video_length, f)
        out = dot_product_attention(q, k, v).reshape(bd, f, -1).to(x.dtype)
        o = self.to_out(out)
        if self.lora:
            o = o + lora_scale * self.to_out_lora(out)
        return o


class TemporalTransformerBlock(nn.Module):
    """Pre-LN temporal attentions with residuals, then LN → GEGLU FF.
    ``attention_head_dim`` may be less than ``dim / heads``
    (``temporal_attention_dim_div``); the block's width stays ``dim``."""

    def __init__(self, dim: int, num_attention_heads: int,
                 attention_head_dim: int,
                 attention_block_types: Sequence[str] = _STANDARD,
                 temporal_position_encoding: bool = True,
                 temporal_position_encoding_max_len: int = 24,
                 use_rope: bool = False, train_video_length: int = 16,
                 add_temporal_lora: bool = False, lora_rank: int = 4):
        super().__init__()
        self.dim = dim
        self.heads = num_attention_heads
        self.head_dim = attention_head_dim
        self.block_types = tuple(attention_block_types)
        self.pe = temporal_position_encoding
        self.pe_max_len = temporal_position_encoding_max_len
        self.use_rope = use_rope
        self.lora = add_temporal_lora
        self.norms = nn.ModuleList(LayerNorm(dim)
                                   for _ in attention_block_types)
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, num_attention_heads, attention_head_dim,
                              temporal_position_encoding,
                              temporal_position_encoding_max_len, use_rope,
                              train_video_length, add_temporal_lora,
                              lora_rank)
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

    def qkv_weights(self) -> tuple:
        """The bf16 kernel's ``[Wq; Wk; Wv]`` of both attentions, each
        module's cached :meth:`TemporalAttention.qkv_weight`."""
        return tuple(a.qkv_weight() for a in self.attention_blocks)

    def whole_block_kernel(self, h: torch.Tensor,
                           pab: Optional[PabMode]) -> bool:
        """The route: the whole-block kernel, or the modular path."""
        pab_temporal = pab is not None and (pab.record("temporal")
                                            or pab.reuse("temporal"))
        return (h.device.type == "cuda" and not pab_temporal
                and self.block_types == _STANDARD
                and not self.use_rope and not self.lora
                and self.heads * self.head_dim == self.dim
                and self.dim <= 1280
                and motion_block.fits(h.shape[1], self.dim, self.heads,
                                      h.dtype))

    def forward(self, h: torch.Tensor, pab: Optional[PabMode] = None,
                cache: Optional[dict] = None) -> torch.Tensor:
        if self.whole_block_kernel(h, pab):
            pe = _pe_table(self.pe, self.pe_max_len, h.shape[1], self.dim, h)
            qkv = self.qkv_weights() if h.dtype == torch.bfloat16 else None
            return fused_motion_block(h.contiguous(), pe, self.fused_params(),
                                      scale=self.head_dim ** -0.5,
                                      heads=self.heads, qkv=qkv)
        for i, (norm, attn) in enumerate(zip(self.norms,
                                             self.attention_blocks)):
            h = pab_site(self, "temporal", f"attn_{i}_out", pab, cache,
                         lambda h=h, norm=norm, attn=attn: attn(norm(h))) + h
        return _ln_ff_residual(self.ff_norm, self.ff, h)


class MotionModule(nn.Module):
    """GroupNorm (per frame, 32 groups, eps 1e-6) → proj_in → blocks in the
    frames-minor ``(B·H·W, F, C)`` layout → proj_out → +residual."""

    def __init__(self, in_channels: int, config: MotionModuleConfig):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm(c, 32, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(
                c, config.num_attention_heads,
                c // config.num_attention_heads
                // config.temporal_attention_dim_div,
                tuple(config.attention_block_types),
                config.temporal_position_encoding,
                config.temporal_position_encoding_max_len,
                config.use_rope_position_encoding,
                config.train_video_length, config.add_temporal_lora,
                config.lora_rank)
            for _ in range(config.num_transformer_block))
        self.proj_out = nn.Linear(c, c)
        if config.zero_initialize:
            nn.init.zeros_(self.proj_out.weight)
            nn.init.zeros_(self.proj_out.bias)

    def forward(self, hidden_states: torch.Tensor,
                pab: Optional[PabMode] = None,
                cache: Optional[dict] = None) -> torch.Tensor:
        b, f, hh, ww, c = hidden_states.shape
        residual = hidden_states.reshape(b * f, hh, ww, c)
        x = self.proj_in(self.norm(residual).reshape(b * f, hh * ww, c))
        x = x.reshape(b, f, hh * ww, c).permute(0, 2, 1, 3).reshape(
            b * hh * ww, f, c)
        for block in self.transformer_blocks:
            x = block(x, pab, cache)
        x = self.proj_out(x)
        x = x.reshape(b, hh * ww, f, c).permute(0, 2, 1, 3).reshape(
            b * f, hh, ww, c) + residual
        return x.reshape(b, f, hh, ww, c)
