"""IP-Adapter image-prompt conditioning: the CLIP vision tower and the token
projection (vanilla ``ImageProjModel`` or the Plus ``Resampler``).

Port of ``followyourclick_tpu/models/ip_adapter.py`` (its own copy of
``CLIPVisionConfig`` included). The decoupled ip key/value attention that
reads these tokens is ``models/attention.CrossAttention(ip_num_tokens=…)``;
the pipeline encodes the image prompt once per request and appends the
tokens to the text context (``pipelines/animation.py``).

Submodule names follow the flax trees, so ``utils/convert.load_jax_params``
fills them: the Resampler's ``layers_{i}_attn``, ``layers_{i}_ff_norm``,
``layers_{i}_ff_in`` and ``layers_{i}_ff_out`` are single flax names and are
registered as such (a ``ModuleList`` would give ``layers.0.attn``, the flax
path ``layers_0/attn``). Images are channels last, ``(B, H, W, 3)``.
Attention goes through ``ops/attention.dot_product_attention``; at the
tower's 257 tokens and the Resampler's queries it takes the plain route.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.models.layers import LayerNorm
from followyourclick_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT (the reference uses ViT-H/14 for IP-Adapter)."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], heads, -1)


class CLIPVisionLayer(nn.Module):
    """pre-LN self-attention and quick-GELU MLP, both residual."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.layer_norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.layer_norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp_fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.layer_norm1(x)
        attn = dot_product_attention(_split_heads(self.q_proj(h), self.heads),
                                     _split_heads(self.k_proj(h), self.heads),
                                     _split_heads(self.v_proj(h), self.heads))
        x = x + self.out_proj(attn.reshape(b, s, d))
        h = self.mlp_fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu
        return x + self.mlp_fc2(h)


class CLIPVisionModel(nn.Module):
    """pixels (B, H, W, 3), CLIP-normalised → (image_embeds (B, proj),
    penultimate hidden states (B, 1 + patches, hidden)): the first feeds the
    vanilla ImageProjModel, the second the Plus Resampler."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        cfg = self.config = config
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(d) * 0.02)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, d)
        self.pre_layrnorm = LayerNorm(d, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(CLIPVisionLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNorm(d, cfg.layer_norm_eps)
        self.visual_projection = nn.Linear(d, cfg.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b = pixel_values.shape[0]
        dtype = self.patch_embedding.weight.dtype
        patches = self.patch_embedding(
            pixel_values.to(dtype).permute(0, 3, 1, 2))     # (B, d, h, w)
        patches = patches.flatten(2).transpose(1, 2)         # (B, h·w, d)
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        x = self.pre_layrnorm(x + self.position_embedding(pos)[None])
        penultimate = x
        for i, layer in enumerate(self.layers):
            if i == len(self.layers) - 1:
                penultimate = x
            x = layer(x)
        pooled = self.post_layernorm(x[:, 0])
        return self.visual_projection(pooled), penultimate


class ImageProjModel(nn.Module):
    """Linear → N tokens → LayerNorm (the vanilla IP-Adapter projection)."""

    def __init__(self, clip_embeddings_dim: int, cross_attention_dim: int = 768,
                 num_tokens: int = 4):
        super().__init__()
        self.num_tokens, self.dim = num_tokens, cross_attention_dim
        self.proj = nn.Linear(clip_embeddings_dim,
                              num_tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds).reshape(-1, self.num_tokens, self.dim)
        return self.norm(x)


class PerceiverAttention(nn.Module):
    """The latents attend to [image features; latents], q and k each scaled
    by d^-1/4 (f16-stable), the attention at scale 1."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, n, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(self.dim_head))
        out = dot_product_attention(_split_heads(q, self.heads) * scale,
                                    _split_heads(k, self.heads) * scale,
                                    _split_heads(v, self.heads), scale=1.0)
        return self.to_out(out.reshape(b, n, -1))


class Resampler(nn.Module):
    """Perceiver-style token resampler (the IP-Adapter-Plus projection)."""

    def __init__(self, dim: int = 1024, depth: int = 4, dim_head: int = 64,
                 heads: int = 12, num_queries: int = 16,
                 embedding_dim: int = 1280, output_dim: int = 768,
                 ff_mult: int = 4):
        super().__init__()
        self.depth = depth
        self.latents = nn.Parameter(torch.randn(1, num_queries, dim)
                                    / dim ** 0.5)
        self.proj_in = nn.Linear(embedding_dim, dim)
        for i in range(depth):
            self.add_module(f"layers_{i}_attn",
                            PerceiverAttention(dim, dim_head, heads))
            self.add_module(f"layers_{i}_ff_norm", LayerNorm(dim))
            self.add_module(f"layers_{i}_ff_in",
                            nn.Linear(dim, dim * ff_mult, bias=False))
            self.add_module(f"layers_{i}_ff_out",
                            nn.Linear(dim * ff_mult, dim, bias=False))
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNorm(output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        latents = self.latents.to(x.dtype).expand(b, -1, -1)
        x = self.proj_in(x)
        for i in range(self.depth):
            layer = getattr(self, f"layers_{i}_attn")
            latents = layer(x, latents) + latents
            h = getattr(self, f"layers_{i}_ff_norm")(latents)
            h = F.gelu(getattr(self, f"layers_{i}_ff_in")(h),
                       approximate="none")
            latents = getattr(self, f"layers_{i}_ff_out")(h) + latents
        return self.norm_out(self.proj_out(latents))


class IPAdapter(nn.Module):
    """CLIP vision → ImageProjModel (vanilla) or Resampler over the
    penultimate states (Plus). Returns (cond_tokens, uncond_tokens), each
    (B, num_tokens, cross_attention_dim). The uncond tokens are the
    projection of a zero embedding (vanilla) or of a black image's
    features (Plus), as in the reference."""

    def __init__(self, vision_config: CLIPVisionConfig,
                 cross_attention_dim: int = 768, num_tokens: int = 4,
                 plus: bool = False):
        super().__init__()
        self.plus = plus
        self.image_encoder = CLIPVisionModel(vision_config)
        if plus:
            self.image_proj_model = Resampler(
                dim=cross_attention_dim, depth=4, dim_head=64,
                heads=cross_attention_dim // 64, num_queries=num_tokens,
                embedding_dim=vision_config.hidden_size,
                output_dim=cross_attention_dim)
        else:
            self.image_proj_model = ImageProjModel(
                vision_config.projection_dim, cross_attention_dim, num_tokens)

    def forward(self, pixel_values: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        if self.plus:
            _, hidden = self.image_encoder(pixel_values)
            _, black = self.image_encoder(torch.zeros_like(pixel_values))
            return (self.image_proj_model(hidden),
                    self.image_proj_model(black))
        embeds, _ = self.image_encoder(pixel_values)
        cond = self.image_proj_model(embeds)
        return cond, self.image_proj_model(torch.zeros_like(embeds))
