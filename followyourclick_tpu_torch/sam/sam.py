"""The SAM model: preprocessing, encoder + decoder composition, mask
postprocessing, the variant registry and seeded initialisation.

Port of ``followyourclick_tpu/sam/sam.py``: pixel mean/std normalisation
and zero pad to ``img_size``², mask threshold 0, postprocessing (bilinear to
``img_size``², crop the un-padded region, bilinear to the original size).
The last resize antialiases when it shrinks, as ``jax.image.resize`` does
(the reference torch SAM does not). Images are NCHW here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.sam.image_encoder import ImageEncoderViT
from followyourclick_tpu_torch.sam.mask_decoder import MaskDecoder
from followyourclick_tpu_torch.sam.prompt_encoder import PromptEncoder
from followyourclick_tpu_torch.utils.seeded_init import seeded_init_

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MASK_THRESHOLD = 0.0


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """Encoder variant hyper-parameters (the JAX ``SamConfig``)."""

    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    img_size: int = 1024
    prompt_embed_dim: int = 256
    vit_patch_size: int = 16
    mask_in_chans: int = 16
    dtype: torch.dtype = torch.float32

    @property
    def image_embedding_size(self) -> Tuple[int, int]:
        g = self.img_size // self.vit_patch_size
        return (g, g)


sam_model_registry = {
    "default": SamConfig(),
    "vit_h": SamConfig(),
    "vit_l": SamConfig(embed_dim=1024, depth=24, num_heads=16,
                       global_attn_indexes=(5, 11, 17, 23)),
    "vit_b": SamConfig(embed_dim=768, depth=12, num_heads=12,
                       global_attn_indexes=(2, 5, 8, 11)),
    # tiny variant for tests (not in the reference registry)
    "vit_t": SamConfig(embed_dim=64, depth=2, num_heads=2,
                       global_attn_indexes=(1,), img_size=128),
}


class Sam(nn.Module):
    def __init__(self, config: SamConfig = SamConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.image_encoder = ImageEncoderViT(
            img_size=cfg.img_size, patch_size=cfg.vit_patch_size,
            embed_dim=cfg.embed_dim, depth=cfg.depth,
            num_heads=cfg.num_heads, out_chans=cfg.prompt_embed_dim,
            global_attn_indexes=cfg.global_attn_indexes)
        self.prompt_encoder = PromptEncoder(
            embed_dim=cfg.prompt_embed_dim,
            image_embedding_size=cfg.image_embedding_size,
            input_image_size=(cfg.img_size, cfg.img_size),
            mask_in_chans=cfg.mask_in_chans)
        self.mask_decoder = MaskDecoder(transformer_dim=cfg.prompt_embed_dim)
        self.register_buffer("pixel_mean",
                             torch.tensor(PIXEL_MEAN).view(-1, 1, 1), False)
        self.register_buffer("pixel_std",
                             torch.tensor(PIXEL_STD).view(-1, 1, 1), False)

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, h, w) RGB in [0, 255] → normalised, zero-padded to
        ``img_size``²."""
        x = (x - self.pixel_mean) / self.pixel_std
        h, w = x.shape[-2:]
        size = self.config.img_size
        return F.pad(x, (0, size - w, 0, size - h))

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed image → (B, 256, 64, 64) embedding."""
        return self.image_encoder(x)

    def predict_from_embedding(
            self, image_embeddings: torch.Tensor,
            point_coords: Optional[torch.Tensor] = None,
            point_labels: Optional[torch.Tensor] = None,
            boxes: Optional[torch.Tensor] = None,
            mask_input: Optional[torch.Tensor] = None,
            multimask_output: bool = True
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompt encode + mask decode: (low-res logits (B, K, 4h, 4w),
        IoU (B, K))."""
        points = None
        if point_coords is not None:
            points = (point_coords, point_labels)
        sparse, dense = self.prompt_encoder(points, boxes, mask_input)
        return self.mask_decoder(image_embeddings,
                                 self.prompt_encoder.get_dense_pe(), sparse,
                                 dense, multimask_output=multimask_output)

    def forward(self, image: torch.Tensor, point_coords: torch.Tensor,
                point_labels: torch.Tensor, multimask_output: bool = True):
        emb = self.encode_image(self.preprocess(image))
        return self.predict_from_embedding(emb, point_coords, point_labels,
                                           multimask_output=multimask_output)


def postprocess_masks(masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int],
                      img_size: int = 1024) -> torch.Tensor:
    """(B, K, 4h, 4w) logits → (B, K, H_orig, W_orig): bilinear to
    ``img_size``², crop ``input_size``, bilinear to ``original_size`` with
    antialiasing (``jax.image.resize``'s triangle filter widened by the
    shrink; on an enlargement both resizes are plain bilinear)."""
    x = F.interpolate(masks, (img_size, img_size), mode="bilinear",
                      align_corners=False)
    x = x[..., :input_size[0], :input_size[1]]
    return F.interpolate(x, tuple(original_size), mode="bilinear",
                         align_corners=False, antialias=True)


def build_sam(config: SamConfig, device="cuda",
              generator: Optional[torch.Generator] = None,
              state_dict: Optional[dict] = None) -> Sam:
    """A :class:`Sam` on ``device`` in ``config.dtype``, built on the meta
    device and filled from ``state_dict`` (official names, strict) or else
    with seeded values (``utils/seeded_init``, the Gaussian PE matrix too)
    from ``generator`` (a CPU generator seeded 0 when none is given)."""
    with torch.device("meta"):
        model = Sam(config)
    model = model.to_empty(device=device)
    model.pixel_mean.copy_(torch.tensor(PIXEL_MEAN).view(-1, 1, 1))
    model.pixel_std.copy_(torch.tensor(PIXEL_STD).view(-1, 1, 1))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        seeded_init_(model, generator or torch.Generator().manual_seed(0),
                     buffers=("positional_encoding_gaussian_matrix",))
    return model.to(config.dtype).eval()
