"""SAM mask decoder: two-way transformer and hypernetwork mask heads.

Port of ``followyourclick_tpu/sam/mask_decoder.py``: token self-attention →
token-to-image cross-attention (internal width halved) → MLP →
image-to-token cross-attention, the positional encodings re-added at every
layer (not to the first layer's self-attention), then the 4x upscaling by
two 2x2 stride-2 transposed convs, one hypernetwork MLP per mask token and
the IoU head. Official segment-anything names (``iou_token``,
``mask_tokens``, ``transformer.layers.{i}``, ``output_upscaling.{0,1,3}``,
``output_hypernetworks_mlps.{i}.layers.{j}``, ``iou_prediction_head``).
Image maps are NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.sam.image_encoder import LayerNorm2d


class DownsampledAttention(nn.Module):
    """Attention at internal width ``embedding_dim / downsample_rate``."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = q @ k.transpose(-1, -2) / (q.shape[-1] ** 0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampledAttention(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = nn.LayerNorm(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim)
        self.norm3 = nn.LayerNorm(embedding_dim)
        self.norm4 = nn.LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image maps (B, C, H, W), tokens (B, N, C) → (tokens, keys
        (B, HW, C))."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class HyperMLP(nn.Module):
    """``num_layers`` linear layers with ReLU between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, depth: int = 2):
        super().__init__()
        c = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(depth, c, num_heads, mlp_dim)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2),
            LayerNorm2d(c // 4),
            nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            HyperMLP(c, c, c // 8) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = HyperMLP(
            c, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor,
                dense_prompt_embeddings: torch.Tensor,
                multimask_output: bool = True,
                return_all_tokens: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image embeddings (1 or B, C, H, W), PE (1, C, H, W), sparse
        (B, N, C), dense (B, C, H, W) → (mask logits (B, K, 4H, 4W),
        IoU (B, K)): K = 3 (multimask), 1, or all 4 tokens
        (``return_all_tokens``)."""
        B = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(B, -1, -1),
                            sparse_prompt_embeddings], dim=1)
        src = (image_embeddings.expand(B, -1, -1, -1)
               + dense_prompt_embeddings)
        pos_src = image_pe.expand(B, -1, -1, -1)
        _, C, H, W = src.shape
        hs, keys = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]

        upscaled = self.output_upscaling(
            keys.transpose(1, 2).reshape(B, C, H, W))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = upscaled.shape
        masks = (hyper_in @ upscaled.reshape(b, c, h * w)).reshape(b, -1, h, w)
        iou_pred = self.iou_prediction_head(iou_token_out)

        if return_all_tokens:
            return masks, iou_pred
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
