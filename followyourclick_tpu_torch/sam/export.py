"""The single-call SAM decoder and its deployable artifact.

Port of ``followyourclick_tpu/sam/export.py`` (the reference's ONNX export,
``segment_anything/utils/onnx.py``): prompt encode, mask decode and
postprocessing in one call on a cached image embedding. The artifact is a
``torch.export`` program saved to bytes by ``torch.export.save`` (the JAX
package's is a serialized StableHLO module); :func:`load_decoder` reloads
it. As in JAX, the original image size is a build-time constant.
"""

from __future__ import annotations

import io
from typing import Tuple

import torch
from torch import nn

from followyourclick_tpu_torch.sam.sam import (
    MASK_THRESHOLD,
    Sam,
    postprocess_masks,
)


def _stability_score(masks: torch.Tensor, threshold: float,
                     offset: float) -> torch.Tensor:
    high = (masks > threshold + offset).sum(dim=(-1, -2)).float()
    low = (masks > threshold - offset).sum(dim=(-1, -2)).float()
    return high / low.clamp(min=1.0)


class SamDecoder(nn.Module):
    """(image_embeddings (B, 256, 64, 64), point_coords (B, N, 2) in the
    ``img_size`` frame padded with a (0, 0) point labelled -1,
    point_labels (B, N), mask_input (B, 1, 256, 256), has_mask_input
    (B, 1, 1, 1)) → (masks (B, K, H0, W0), iou (B, K), low-res (B, K, 256,
    256)). With ``return_single_mask``, K = 1: the reference's control-flow
    free choice (more than one real click → token 0, else the best of the
    multimask tokens by score)."""

    def __init__(self, model: Sam, orig_im_size: Tuple[int, int],
                 return_single_mask: bool = True,
                 use_stability_score: bool = False):
        super().__init__()
        # the decoder's modules only: an exported program carries the
        # parameters of every submodule it holds
        self.prompt_encoder = model.prompt_encoder
        self.mask_decoder = model.mask_decoder
        self.img_size = model.config.img_size
        h0, w0 = orig_im_size
        self.orig_im_size = (int(h0), int(w0))
        scale = self.img_size / max(h0, w0)
        self.input_size = (int(h0 * scale + 0.5), int(w0 * scale + 0.5))
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score

    def forward(self, image_embeddings, point_coords, point_labels,
                mask_input, has_mask_input):
        pe = self.prompt_encoder
        sparse = pe._embed_points(point_coords, point_labels, pad=False)
        dense = has_mask_input * pe.mask_downscaling(mask_input)
        dense = dense + (1.0 - has_mask_input) * pe.no_mask_embed.weight \
            .reshape(1, -1, 1, 1)
        masks, scores = self.mask_decoder(
            image_embeddings, pe.get_dense_pe(), sparse, dense,
            return_all_tokens=True)
        if self.use_stability_score:
            scores = _stability_score(masks, MASK_THRESHOLD, 1.0)
        if self.return_single_mask:
            num_points = point_coords.shape[1]
            reweight = torch.tensor([1000.0] + [0.0] * (masks.shape[1] - 1),
                                    dtype=scores.dtype, device=scores.device)
            best = torch.argmax(scores + (num_points - 2.5) * reweight, dim=1)
            b_idx = torch.arange(masks.shape[0], device=masks.device)
            masks = masks[b_idx, best][:, None]
            scores = scores[b_idx, best][:, None]
        up = postprocess_masks(masks, self.input_size, self.orig_im_size,
                               self.img_size)
        return up, scores, masks


def build_decoder_fn(model: Sam, orig_im_size: Tuple[int, int],
                     return_single_mask: bool = True,
                     use_stability_score: bool = False) -> SamDecoder:
    """The single-call decoder as a module (callable)."""
    return SamDecoder(model, orig_im_size, return_single_mask,
                      use_stability_score).eval()


def example_inputs(model: Sam, batch: int = 1, num_points: int = 2):
    """Zero inputs of the decoder's shapes on the model's device."""
    dev = next(model.parameters()).device
    e = model.config.prompt_embed_dim
    h, w = model.config.image_embedding_size
    return (torch.zeros(batch, e, h, w, device=dev),
            torch.zeros(batch, num_points, 2, device=dev),
            torch.zeros(batch, num_points, device=dev),
            torch.zeros(batch, 1, 4 * h, 4 * w, device=dev),
            torch.zeros(batch, 1, 1, 1, device=dev))


def export_decoder(model: Sam, orig_im_size: Tuple[int, int], batch: int = 1,
                   num_points: int = 2,
                   return_single_mask: bool = True) -> bytes:
    """``torch.export`` of the decoder at static shapes, saved to bytes."""
    fn = build_decoder_fn(model, orig_im_size, return_single_mask)
    with torch.no_grad():
        program = torch.export.export(fn, example_inputs(model, batch,
                                                         num_points))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_decoder(blob: bytes) -> nn.Module:
    """The saved program as a callable module."""
    return torch.export.load(io.BytesIO(blob)).module()
