"""SAM ViT image encoder (ViTDet).

Port of ``followyourclick_tpu/sam/image_encoder.py``: a 16x16 patch embed,
learned absolute positions, 14x14 windowed attention with decomposed
relative-position biases on all but the ``global_attn_indexes`` blocks, and
a conv neck to 256 channels. The modules carry the official
segment-anything parameter names (``patch_embed.proj``, ``blocks.{i}.attn.
qkv``, ``neck.{0..3}``, ...), so an official ``sam_vit_{h,l,b}.pth`` loads
with ``load_state_dict(strict=True)``. The blocks run channels-last
``(B, H, W, C)``; the encoder takes ``(B, 3, S, S)`` and returns
``(B, 256, S/16, S/16)``, as the official module does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW map (the variance as the
    mean of squared deviations)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(1, keepdim=True)
        var = (x - mean).pow(2).mean(1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def window_partition(x: torch.Tensor, window: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) → (B*nW, window, window, C), zero-padded at the bottom
    and right. The padded zeros stay keys of their windows."""
    B, H, W, C = x.shape
    ph, pw = (-H) % window, (-W) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C)
    return x, (Hp, Wp)


def window_unpartition(x: torch.Tensor, window: int, padded: Tuple[int, int],
                       orig: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = padded
    H, W = orig
    B = x.shape[0] // ((Hp // window) * (Wp // window))
    x = x.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _decomposed_rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor,
                             rel_pos_w: torch.Tensor,
                             hw: Tuple[int, int]) -> torch.Tensor:
    """bias[b, qh qw, kh kw] = q·Rh[qh-kh] + q·Rw[qw-kw] for the unscaled
    ``q`` (B*, H*W, head_dim); square attention (q and k of one grid)."""
    H, W = hw
    dev = q.device
    idx_h = (torch.arange(H, device=dev)[:, None]
             - torch.arange(H, device=dev)[None, :] + (H - 1))
    idx_w = (torch.arange(W, device=dev)[:, None]
             - torch.arange(W, device=dev)[None, :] + (W - 1))
    Rh, Rw = rel_pos_h[idx_h], rel_pos_w[idx_w]  # (H, H, d), (W, W, d)
    B = q.shape[0]
    r_q = q.reshape(B, H, W, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    bias = rel_h[:, :, :, :, None] + rel_w[:, :, None, :, :]
    return bias.reshape(B, H * W, H * W)


class ViTAttention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias, added to
    ``q·scale @ kᵀ`` before the fp32 softmax (SDPA with the bias as its
    float mask)."""

    def __init__(self, dim: int, num_heads: int,
                 input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        heads = self.num_heads
        hd = C // heads
        qkv = self.qkv(x).reshape(B, H * W, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, heads, N, hd)
        bias = _decomposed_rel_pos_bias(
            q.reshape(B * heads, H * W, hd), self.rel_pos_h, self.rel_pos_w,
            (H, W)).reshape(B, heads, H * W, H * W)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(
            q.dtype))
        out = out.permute(0, 2, 1, 3).reshape(B, H, W, C)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))  # exact GELU


class ViTBlock(nn.Module):
    """Pre-norm block; windowed when ``window_size > 0`` (the window pad
    comes after ``norm1``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 0,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(
            dim, num_heads,
            (window_size, window_size) if window_size > 0 else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window_size > 0:
            orig = y.shape[1:3]
            y, padded = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, padded, orig)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)  # NCHW → NHWC


class ImageEncoderViT(nn.Module):
    """(B, 3, img_size, img_size) → (B, out_chans, grid, grid)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)):
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio,
                     0 if i in global_attn_indexes else window_size,
                     (grid, grid))
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2))
