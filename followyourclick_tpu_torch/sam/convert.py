"""SAM checkpoints for the port.

The port's SAM modules carry the official segment-anything parameter names,
so an official ``sam_vit_{h,l,b}.pth`` is the port's state dict as it is:
:func:`load_sam_checkpoint` reads it with ``torch.load(weights_only=True)``
and :func:`build_sam` loads it strictly, with no conversion.

:func:`sam_state_from_jax` is the inverse of the JAX package's
``sam/convert.convert_sam_state_dict``: the JAX ``Sam``'s flax parameter
tree (nested dicts of arrays) → an official-named state dict, so the two
packages can run on the same weights. Layouts: a flax Dense kernel
``(in, out)`` → Linear ``(out, in)``; a Conv kernel ``(kh, kw, in, out)``
→ ``(out, in, kh, kw)``; a ConvTranspose kernel (``transpose_kernel=True``)
``(kh, kw, out, in)`` → ``(in, out, kh, kw)``; ``point_embeddings`` (4, C)
→ four ``(1, C)`` embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from followyourclick_tpu_torch.sam.sam import Sam, SamConfig, build_sam
from followyourclick_tpu_torch.utils.convert import state_dict_from_tree


def load_sam_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """An official SAM ``.pth`` (a flat state dict) → its tensors, on the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _linear(tree):
    out = {"weight": np.asarray(tree["kernel"]).T}
    if "bias" in tree:
        out["bias"] = np.asarray(tree["bias"])
    return out


def _conv(tree):
    out = {"weight": np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in tree:
        out["bias"] = np.asarray(tree["bias"])
    return out


def _conv_transpose(tree):
    # flax (kh, kw, out, in) → torch ConvTranspose2d (in, out, kh, kw)
    return {"weight": np.asarray(tree["kernel"]).transpose(3, 2, 0, 1),
            "bias": np.asarray(tree["bias"])}


def _ln(tree):
    return {"weight": np.asarray(tree["scale"]),
            "bias": np.asarray(tree["bias"])}


def _ln2d(tree):
    return {"weight": np.asarray(tree["weight"]),
            "bias": np.asarray(tree["bias"])}


def _attention(tree):
    return {name: _linear(tree[name])
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}


def sam_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``Sam``'s ``params`` tree (``variables["params"]``) → the
    official-named state dict (fp32 CPU tensors). A tree from ``Sam.init``
    without a mask prompt lacks the mask-downscaling convs (flax creates a
    submodule's parameters at its first call), and so does the result."""
    enc, pe, dec = (params["image_encoder"], params["prompt_encoder"],
                    params["mask_decoder"])
    blocks = sorted((k for k in enc if k.startswith("block")),
                    key=lambda k: int(k[5:]))
    image_encoder = {
        "patch_embed": {"proj": _conv(enc["patch_embed"])},
        "neck": {"0": _conv(enc["neck_conv1"]), "1": _ln2d(enc["neck_ln1"]),
                 "2": _conv(enc["neck_conv2"]), "3": _ln2d(enc["neck_ln2"])},
        "blocks": {
            str(i): {
                "norm1": _ln(enc[b]["norm1"]), "norm2": _ln(enc[b]["norm2"]),
                "attn": {"qkv": _linear(enc[b]["attn"]["qkv"]),
                         "proj": _linear(enc[b]["attn"]["proj"]),
                         "rel_pos_h": enc[b]["attn"]["rel_pos_h"],
                         "rel_pos_w": enc[b]["attn"]["rel_pos_w"]},
                "mlp": {"lin1": _linear(enc[b]["mlp_lin1"]),
                        "lin2": _linear(enc[b]["mlp_lin2"])}}
            for i, b in enumerate(blocks)},
    }
    if "pos_embed" in enc:
        image_encoder["pos_embed"] = enc["pos_embed"]
    points = np.asarray(pe["point_embeddings"])
    prompt_encoder = {
        "pe_layer": {"positional_encoding_gaussian_matrix":
                     pe["pe_layer"]["positional_encoding_gaussian_matrix"]},
        "point_embeddings": {str(i): {"weight": points[i:i + 1]}
                             for i in range(points.shape[0])},
        "not_a_point_embed": {"weight": pe["not_a_point_embed"]},
        "no_mask_embed": {"weight": pe["no_mask_embed"]},
    }
    if "mask_conv1" in pe:  # a flax init without a mask prompt has none
        prompt_encoder["mask_downscaling"] = {
            "0": _conv(pe["mask_conv1"]), "1": _ln2d(pe["mask_ln1"]),
            "3": _conv(pe["mask_conv2"]), "4": _ln2d(pe["mask_ln2"]),
            "6": _conv(pe["mask_conv3"])}
    tr = dec["transformer"]
    layers = sorted((k for k in tr if k.startswith("layer")),
                    key=lambda k: int(k[5:]))
    transformer = {
        "layers": {str(i): {
            "self_attn": _attention(tr[name]["self_attn"]),
            "norm1": _ln(tr[name]["norm1"]),
            "cross_attn_token_to_image": _attention(
                tr[name]["cross_attn_token_to_image"]),
            "norm2": _ln(tr[name]["norm2"]),
            "mlp": {"lin1": _linear(tr[name]["mlp_lin1"]),
                    "lin2": _linear(tr[name]["mlp_lin2"])},
            "norm3": _ln(tr[name]["norm3"]),
            "cross_attn_image_to_token": _attention(
                tr[name]["cross_attn_image_to_token"]),
            "norm4": _ln(tr[name]["norm4"])}
            for i, name in enumerate(layers)},
        "final_attn_token_to_image": _attention(
            tr["final_attn_token_to_image"]),
        "norm_final_attn": _ln(tr["norm_final_attn"]),
    }
    hyper = sorted((k for k in dec if k.startswith("hyper_mlp")),
                   key=lambda k: int(k[9:]))
    mask_decoder = {
        "iou_token": {"weight": dec["iou_token"]},
        "mask_tokens": {"weight": dec["mask_tokens"]},
        "transformer": transformer,
        "output_upscaling": {"0": _conv_transpose(dec["upscale_conv1"]),
                             "1": _ln2d(dec["upscale_ln"]),
                             "3": _conv_transpose(dec["upscale_conv2"])},
        "output_hypernetworks_mlps": {
            str(i): {"layers": {str(j): _linear(dec[h][f"layer{j}"])
                                for j in range(len(dec[h]))}}
            for i, h in enumerate(hyper)},
        "iou_prediction_head": {"layers": {
            str(j): _linear(dec["iou_prediction_head"][f"layer{j}"])
            for j in range(len(dec["iou_prediction_head"]))}},
    }
    return state_dict_from_tree({"image_encoder": image_encoder,
                                 "prompt_encoder": prompt_encoder,
                                 "mask_decoder": mask_decoder})


def sam_from_checkpoint(config: SamConfig, path: Optional[str] = None,
                        device="cuda",
                        generator: Optional[torch.Generator] = None) -> Sam:
    """An official ``.pth`` at ``path`` loaded strictly into a :class:`Sam`
    on ``device``, or, without ``path``, seeded random weights from
    ``generator``."""
    state = load_sam_checkpoint(path) if path else None
    return build_sam(config, device, generator=generator, state_dict=state)
