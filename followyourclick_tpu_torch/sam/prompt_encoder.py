"""SAM prompt encoder.

Port of ``followyourclick_tpu/sam/prompt_encoder.py``: random-Fourier
positional encoding, four learned point embeddings (negative point,
positive point, box corner 1, box corner 2) and a not-a-point embedding, a
conv mask-downscaling path, and the no-mask embedding broadcast as the
dense embedding when no mask prompt is given. Point coordinates shift by
+0.5 to pixel centres; label 1 = foreground, 0 = background, -1 = padding.

Official segment-anything names: ``pe_layer.positional_encoding_gaussian_
matrix`` (a buffer there and here, so it travels with the state dict),
``point_embeddings.{0..3}``, ``not_a_point_embed``, ``no_mask_embed`` (each
an ``nn.Embedding(1, C)``) and ``mask_downscaling.{0,1,3,4,6}``. Dense maps
are NCHW.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from followyourclick_tpu_torch.sam.image_encoder import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """coords in [0, 1]² → 2c - 1 → @ (2, F) Gaussian matrix → 2π →
    [sin | cos]."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def _encode(self, coords: torch.Tensor) -> torch.Tensor:
        coords = 2 * coords - 1
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size: Tuple[int, int]) -> torch.Tensor:
        """Dense PE ``(2F, h, w)`` of the image-embedding grid."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
        return self._encode(grid).permute(2, 0, 1)

    def forward_with_coords(self, coords: torch.Tensor,
                            image_size: Tuple[int, int]) -> torch.Tensor:
        """Encode pixel coordinates ``(..., 2)`` (x, y) of an image of
        ``image_size`` (h, w)."""
        scale = torch.tensor([image_size[1], image_size[0]],
                             dtype=coords.dtype, device=coords.device)
        return self._encode(coords / scale)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2),
            LayerNorm2d(mask_in_chans // 4),
            nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans),
            nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, embed_dim, h, w) PE of the image-embedding grid."""
        return self.pe_layer(self.image_embedding_size)[None]

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool) -> torch.Tensor:
        points = points + 0.5  # centre of pixel
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :1])], 1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], 1)
        pe = self.pe_layer.forward_with_coords(points, self.input_image_size)
        lbl = labels[..., None]
        pe = torch.where(lbl == -1, torch.zeros_like(pe), pe)
        pe = pe + torch.where(lbl == -1, self.not_a_point_embed.weight[0], 0.0)
        pe = pe + torch.where(lbl == 0, self.point_embeddings[0].weight[0],
                              0.0)
        pe = pe + torch.where(lbl == 1, self.point_embeddings[1].weight[0],
                              0.0)
        return pe

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        corners = (boxes + 0.5).reshape(-1, 2, 2)
        pe = self.pe_layer.forward_with_coords(corners, self.input_image_size)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return pe + corner

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]],
                boxes: Optional[torch.Tensor], masks: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sparse (B, N, C), dense (B, C, h, w)); ``masks`` (B, 1, 4h, 4w)
        logits."""
        if points is not None:
            bs = points[0].shape[0]
        elif boxes is not None:
            bs = boxes.shape[0]
        elif masks is not None:
            bs = masks.shape[0]
        else:
            bs = 1
        w = self.no_mask_embed.weight
        sparse = torch.empty((bs, 0, self.embed_dim), dtype=w.dtype,
                             device=w.device)
        if points is not None:
            coords, labels = points
            sparse = torch.cat([sparse, self._embed_points(
                coords, labels, pad=boxes is None)], dim=1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], dim=1)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
                bs, -1, *self.image_embedding_size)
        return sparse, dense

