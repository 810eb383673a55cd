"""LDM ("CompVis") checkpoint key remapping → diffusers names.

The port's own copy of ``followyourclick_tpu/utils/ldm.py`` (pure key
remapping, no JAX): ``convert_ldm_unet`` (``model.diffusion_model.*``:
time_embed / input_blocks / middle_block / output_blocks),
``convert_ldm_vae`` (``first_stage_model.*``) and ``convert_ldm_clip``
(``cond_stage_model.transformer.*``) of the standard SD-1.x layout. The
output names feed ``utils/convert.py``, so a personalized full-SD
``.safetensors`` or ``.ckpt`` loads over the base weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

_RES_MAP = (
    ("in_layers.0", "norm1"),
    ("in_layers.2", "conv1"),
    ("emb_layers.1", "time_emb_proj"),
    ("out_layers.0", "norm2"),
    ("out_layers.3", "conv2"),
    ("skip_connection", "conv_shortcut"),
)


def _map_resnet(key_rest: str) -> str:
    for old, new in _RES_MAP:
        if key_rest.startswith(old):
            return new + key_rest[len(old):]
    return key_rest


def convert_ldm_unet(state_dict: Mapping, layers_per_block: int = 2) -> Dict:
    """``model.diffusion_model.*`` → diffusers UNet2D names."""
    sd = {k[len("model.diffusion_model."):]: v for k, v in state_dict.items()
          if k.startswith("model.diffusion_model.")}
    if not sd:
        sd = dict(state_dict)
    out: Dict = {}
    per = layers_per_block + 1  # resnets per block + downsample slot

    for key, value in sd.items():
        parts = key.split(".")
        if key.startswith("time_embed.0."):
            out["time_embedding.linear_1." + parts[-1]] = value
        elif key.startswith("time_embed.2."):
            out["time_embedding.linear_2." + parts[-1]] = value
        elif key.startswith("input_blocks.0.0."):
            out["conv_in." + parts[-1]] = value
        elif key.startswith("out.0."):
            out["conv_norm_out." + parts[-1]] = value
        elif key.startswith("out.2."):
            out["conv_out." + parts[-1]] = value
        elif key.startswith("input_blocks."):
            i = int(parts[1])
            op = int(parts[2])
            rest = ".".join(parts[3:])
            block_id = (i - 1) // per
            layer = (i - 1) % per
            if layer == layers_per_block:  # downsample slot
                out[f"down_blocks.{block_id}.downsamplers.0.conv."
                    + parts[-1]] = value
            elif op == 0:
                out[f"down_blocks.{block_id}.resnets.{layer}."
                    + _map_resnet(rest)] = value
            else:
                out[f"down_blocks.{block_id}.attentions.{layer}."
                    + rest] = value
        elif key.startswith("middle_block."):
            op = int(parts[1])
            rest = ".".join(parts[2:])
            if op == 0:
                out["mid_block.resnets.0." + _map_resnet(rest)] = value
            elif op == 1:
                out["mid_block.attentions.0." + rest] = value
            else:
                out["mid_block.resnets.1." + _map_resnet(rest)] = value
        elif key.startswith("output_blocks."):
            i = int(parts[1])
            op = int(parts[2])
            rest = ".".join(parts[3:])
            block_id = i // per
            layer = i % per
            if op == 0:
                out[f"up_blocks.{block_id}.resnets.{layer}."
                    + _map_resnet(rest)] = value
            else:
                # op >= 1 is either the attention or the upsampler conv
                if rest.startswith("conv."):
                    out[f"up_blocks.{block_id}.upsamplers.0."
                        + rest] = value
                else:
                    out[f"up_blocks.{block_id}.attentions.{layer}."
                        + rest] = value
        # else: drop (label_emb etc. absent in SD1.x)
    return out


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

_VAE_RES_MAP = (("nin_shortcut", "conv_shortcut"),)
_VAE_ATTN_MAP = (
    ("norm.", "group_norm."),
    ("q.", "query."),
    ("k.", "key."),
    ("v.", "value."),
    ("proj_out.", "proj_attn."),
)


def _map_vae_resnet(rest: str) -> str:
    for old, new in _VAE_RES_MAP:
        rest = rest.replace(old, new)
    return rest


def _map_vae_attn(rest: str) -> str:
    for old, new in _VAE_ATTN_MAP:
        if rest.startswith(old):
            return new + rest[len(old):]
    return rest


def convert_ldm_vae(state_dict: Mapping, num_blocks: int = 4) -> Dict:
    """``first_stage_model.*`` → diffusers AutoencoderKL names."""
    sd = {k[len("first_stage_model."):]: v for k, v in state_dict.items()
          if k.startswith("first_stage_model.")}
    if not sd:
        sd = dict(state_dict)
    out: Dict = {}
    for key, value in sd.items():
        parts = key.split(".")
        if key.startswith("encoder.down."):
            i = int(parts[2])
            if parts[3] == "block":
                j = int(parts[4])
                rest = _map_vae_resnet(".".join(parts[5:]))
                out[f"encoder.down_blocks.{i}.resnets.{j}.{rest}"] = value
            elif parts[3] == "downsample":
                out[f"encoder.down_blocks.{i}.downsamplers.0."
                    + ".".join(parts[4:])] = value
        elif key.startswith("decoder.up."):
            i = int(parts[2])
            rev = num_blocks - 1 - i  # LDM decoder blocks are reversed
            if parts[3] == "block":
                j = int(parts[4])
                rest = _map_vae_resnet(".".join(parts[5:]))
                out[f"decoder.up_blocks.{rev}.resnets.{j}.{rest}"] = value
            elif parts[3] == "upsample":
                out[f"decoder.up_blocks.{rev}.upsamplers.0."
                    + ".".join(parts[4:])] = value
        elif parts[0] in ("encoder", "decoder") and parts[1] == "mid":
            stage = parts[0]
            if parts[2] == "block_1":
                out[f"{stage}.mid_block.resnets.0."
                    + _map_vae_resnet(".".join(parts[3:]))] = value
            elif parts[2] == "block_2":
                out[f"{stage}.mid_block.resnets.1."
                    + _map_vae_resnet(".".join(parts[3:]))] = value
            elif parts[2] == "attn_1":
                out[f"{stage}.mid_block.attentions.0."
                    + _map_vae_attn(".".join(parts[3:]))] = value
        elif parts[0] in ("encoder", "decoder") and parts[1] == "norm_out":
            out[f"{parts[0]}.conv_norm_out." + ".".join(parts[2:])] = value
        elif parts[0] in ("encoder", "decoder") and parts[1] in (
                "conv_in", "conv_out"):
            out[key] = value
        elif parts[0] in ("quant_conv", "post_quant_conv"):
            out[key] = value
    return out


def convert_ldm_clip(state_dict: Mapping) -> Dict:
    """``cond_stage_model.transformer.*`` → HF CLIPText names."""
    prefix = "cond_stage_model.transformer."
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    return sd if sd else dict(state_dict)
