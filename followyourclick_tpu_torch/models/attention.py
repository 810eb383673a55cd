"""Spatial transformer blocks (self-attention → text cross-attention → FF).

Port of ``followyourclick_tpu/models/attention.py`` with the PAB sites of
the self-attention (``attn1_out``, kind ``spatial``), the text
cross-attention (``attn2_out``, kind ``cross``; with IP-Adapter tokens it
wraps the whole output, ip part included), the T5 cross-attention
(``attn_t5_out``, kind ``cross``) and the in-block temporal attention
(``attn_temp_out``, kind ``temporal``). Options: cross-frame self-attention
(keys and values from frame 0 and the previous frame), ``upcast_attention``
(q and k in fp32), the T5 cross-attention over the projected T5 states
(skipped when a call brings none) and the in-block temporal attention over
the frames at every position. ``use_linear_projection`` needs nothing here:
a 1×1 conv and a Dense are the same ``nn.Linear``, and
``utils/convert.py`` takes either kernel.

Tensor parallel (``parallel/sharding.shard_params`` sets ``tp``, the mesh):
an attention runs its rank's heads (q, k, v split on their output rows, the
out-projection on its input columns, one all-reduce after it) and the
GEGLU feed-forward its rank's columns of h and of the gate, with no
hand-written kernel of whole weights (``fused_ln_geglu``, ``fused_geglu``);
the attention core routes on the global head count
(``ops/attention.route``) and runs on the local heads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.models.layers import GroupNorm, LayerNorm
from followyourclick_tpu_torch.models.pab import PabMode, pab_site
from followyourclick_tpu_torch.ops.attention import dot_product_attention
from followyourclick_tpu_torch.ops.geglu import fused_geglu, fused_ln_geglu
from followyourclick_tpu_torch.parallel.tensor_parallel import (
    column_linear,
    copy_to_model,
    row_linear,
)


def model_ranks(mesh) -> int:
    """The ranks a tensor-parallel module's heads split over (1 off TP)."""
    return 1 if mesh is None else mesh.model_size


class CrossAttention(nn.Module):
    """q/k/v projections (no bias) → multi-head attention → out projection.

    ``ip_num_tokens > 0`` adds the decoupled IP-Adapter path: the last
    ``ip_num_tokens`` of the context are image-prompt tokens, attended
    through ``to_k_ip``/``to_v_ip`` and added as ``out + ip_scale·ip_out``.
    The upstream scale quirk is kept for checkpoint parity: with ip on, both
    attentions run at ``scale = ip_scale``, not ``dim_head**-0.5``
    (``followyourclick_tpu/models/attention.py:103-111``).
    """

    tp = None  # the mesh, once shard_params keeps this rank's heads

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None,
                 ip_num_tokens: int = 0, ip_scale: float = 1.0,
                 upcast_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.ip_num_tokens, self.ip_scale = ip_num_tokens, ip_scale
        self.upcast = upcast_attention
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)
        if ip_num_tokens > 0:
            self.to_k_ip = nn.Linear(kv_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(kv_dim, inner, bias=False)

    def forward(self, hidden_states: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                attention_bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        mesh = self.tp
        x = copy_to_model(hidden_states, mesh)
        context = x if context is None else copy_to_model(context, mesh)
        b, s, _ = hidden_states.shape

        def split(t):  # this rank's heads under TP
            return t.reshape(t.shape[0], t.shape[1], -1, self.dim_head)

        ip_context, scale = None, None
        if self.ip_num_tokens > 0:
            end = context.shape[1] - self.ip_num_tokens
            context, ip_context = context[:, :end], context[:, end:]
            scale = self.ip_scale
        ranks = model_ranks(mesh)
        q = split(self.to_q(x))
        k = split(self.to_k(context))
        if self.upcast:
            q, k = q.float(), k.float()
        out = dot_product_attention(q, k, split(self.to_v(context)),
                                    bias=attention_bias, scale=scale,
                                    model_ranks=ranks)
        if ip_context is not None:
            ip_k = split(self.to_k_ip(ip_context))
            if self.upcast:
                ip_k = ip_k.float()
            ip_out = dot_product_attention(q, ip_k,
                                           split(self.to_v_ip(ip_context)),
                                           scale=scale, model_ranks=ranks)
            out = out + self.ip_scale * ip_out
        out = out.reshape(b, s, -1).to(hidden_states.dtype)
        if mesh is not None:
            return row_linear(out, self.to_out, mesh)
        return self.to_out(out)


class GEGLUFeedForward(nn.Module):
    """proj to 2·(mult·dim) → h · gelu(gate) → out. On a CUDA tensor one
    launch of ``ops/geglu.fused_geglu`` (the JAX module's kernel branch);
    elsewhere the plain layers with the exact erf gate. The sampler reaches
    neither: :func:`_ln_ff_residual` takes the fused LN-GEGLU kernel on the
    card and calls this module only on the CPU. Under TP (``tp``) the
    plain layers on this rank's columns of h and the gate, one all-reduce
    after ``out``, on any device."""

    tp = None  # the mesh, once shard_params keeps this rank's columns

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = nn.Linear(dim, 2 * inner)
        self.out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            h, gate = column_linear(x, self.proj, self.tp).chunk(2, dim=-1)
            return row_linear(h * F.gelu(gate, approximate="none"), self.out,
                              self.tp)
        if x.device.type == "cuda":
            y = fused_geglu(x.reshape(-1, x.shape[-1]), self.proj.weight,
                            self.proj.bias, self.out.weight, self.out.bias)
            return y.reshape(*x.shape[:-1], self.out.out_features)
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate, approximate="none"))


def _ln_ff_residual(norm: LayerNorm, ff: GEGLUFeedForward,
                    h: torch.Tensor) -> torch.Tensor:
    """LayerNorm → GEGLU FF → +h. On a CUDA tensor this is one launch of the
    hand-written kernel (ops/geglu.fused_ln_geglu); elsewhere, and under
    TP (the kernel holds whole weights), the modular path, as the JAX
    package runs it off the TPU."""
    if h.device.type == "cuda" and ff.tp is None:
        out = fused_ln_geglu(h.reshape(-1, h.shape[-1]), norm.weight,
                             norm.bias, ff.proj.weight, ff.proj.bias,
                             ff.out.weight, ff.out.bias, eps=norm.eps,
                             residual=True)
        return out.reshape(h.shape)
    return ff(norm(h)) + h


class BasicTransformerBlock(nn.Module):
    """self-attention → text cross-attention [→ T5 cross-attention] [→
    temporal attention] → GEGLU FF, pre-LN residuals. Rows are ``(B·F, S,
    C)``; the cross-frame and temporal options need ``video_length``."""

    def __init__(self, dim: int, num_attention_heads: int,
                 attention_head_dim: int, cross_attention_dim: int = 768,
                 ip_num_tokens: int = 0, ip_scale: float = 1.0,
                 upcast_attention: bool = False,
                 use_text_encoder_2: bool = False,
                 cross_frame_attention: bool = False,
                 temporal_attention: bool = False):
        super().__init__()
        heads, dh = num_attention_heads, attention_head_dim
        self.cross_frame = cross_frame_attention
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dh,
                                    upcast_attention=upcast_attention)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dh, cross_attention_dim,
                                    ip_num_tokens, ip_scale, upcast_attention)
        if use_text_encoder_2:
            self.norm_t5 = LayerNorm(dim)
            self.attn_t5 = CrossAttention(dim, heads, dh, cross_attention_dim,
                                          upcast_attention=upcast_attention)
        self.t5 = use_text_encoder_2
        if temporal_attention:
            self.norm_temp = LayerNorm(dim)
            self.attn_temp = CrossAttention(dim, heads, dh)
        self.temporal = temporal_attention
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def _attn1(self, h: torch.Tensor, video_length: Optional[int]
               ) -> torch.Tensor:
        normed = self.norm1(h)
        if not self.cross_frame:
            return self.attn1(normed)
        # keys and values per query frame: [frame 0; the frame before it]
        # (frame 0's own for frame 0)
        bf, s, c = normed.shape
        frames = normed.reshape(bf // video_length, video_length, s, c)
        former = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        kv = torch.cat([frames[:, :1].expand_as(frames), former], dim=2)
        return self.attn1(normed, kv.reshape(bf, 2 * s, c))

    def _attn_temp(self, h: torch.Tensor, video_length: int,
                   pab: Optional[PabMode], cache: Optional[dict]
                   ) -> torch.Tensor:
        bf, s, c = h.shape
        b = bf // video_length
        t = h.reshape(b, video_length, s, c).transpose(1, 2).reshape(
            b * s, video_length, c)
        t = pab_site(self, "temporal", "attn_temp_out", pab, cache,
                     lambda: self.attn_temp(self.norm_temp(t))) + t
        return t.reshape(b, s, video_length, c).transpose(1, 2).reshape(
            bf, s, c)

    def forward(self, hidden_states: torch.Tensor, context: torch.Tensor,
                pab: Optional[PabMode] = None, cache: Optional[dict] = None,
                context_2: Optional[torch.Tensor] = None,
                video_length: Optional[int] = None) -> torch.Tensor:
        h = hidden_states
        h = pab_site(self, "spatial", "attn1_out", pab, cache,
                     lambda: self._attn1(h, video_length)) + h
        # CFG prefix sharing (exact): hidden states at the pre-CFG batch meet
        # context at the doubled [uncond; cond] batch. The halves were equal
        # up to here; duplicate where text conditioning first enters.
        if context.shape[0] != h.shape[0]:
            tile = context.shape[0] // h.shape[0]
            assert tile * h.shape[0] == context.shape[0], \
                (h.shape, context.shape)
            h = torch.cat([h] * tile, dim=0)
        h = pab_site(self, "cross", "attn2_out", pab, cache,
                     lambda: self.attn2(self.norm2(h), context)) + h
        # the T5 cross-attention, skipped on a call without T5 states (the
        # video_scale per-frame pass)
        if self.t5 and context_2 is not None:
            h = pab_site(self, "cross", "attn_t5_out", pab, cache,
                         lambda: self.attn_t5(self.norm_t5(h),
                                              context_2)) + h
        if self.temporal:
            h = self._attn_temp(h, video_length, pab, cache)
        return _ln_ff_residual(self.norm3, self.ff, h)


class SpatialTransformer3D(nn.Module):
    """GroupNorm (per frame) → proj_in → blocks → proj_out → +residual, frames
    folded into the batch. ``ip_num_tokens > 0``: the context ends in that
    many IP-Adapter tokens (``CrossAttention``); ``block_options`` go to
    every :class:`BasicTransformerBlock`."""

    def __init__(self, in_channels: int, num_attention_heads: int,
                 attention_head_dim: int, num_layers: int = 1,
                 cross_attention_dim: int = 768, norm_num_groups: int = 32,
                 ip_num_tokens: int = 0, ip_scale: float = 1.0,
                 **block_options):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.norm = GroupNorm(in_channels, norm_num_groups, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, num_attention_heads,
                                  attention_head_dim, cross_attention_dim,
                                  ip_num_tokens, ip_scale, **block_options)
            for _ in range(num_layers))
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor, context: torch.Tensor,
                pab: Optional[PabMode] = None, cache: Optional[dict] = None,
                context_2: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, f, hh, ww, c = hidden_states.shape
        residual = hidden_states.reshape(b * f, hh, ww, c)
        x = self.norm(residual).reshape(b * f, hh * ww, c)
        x = self.proj_in(x)
        ctx = context.repeat_interleave(f, dim=0)
        ctx2 = None if context_2 is None else \
            context_2.repeat_interleave(f, dim=0)
        for block in self.transformer_blocks:
            x = block(x, ctx, pab, cache, ctx2, f)
        bf_out = x.shape[0]  # CFG-doubled inside the first block when shared
        x = self.proj_out(x).reshape(bf_out, hh, ww, c)
        if bf_out != residual.shape[0]:
            residual = torch.cat([residual] * (bf_out // residual.shape[0]))
        return (x + residual).reshape(bf_out // f, f, hh, ww, c)
