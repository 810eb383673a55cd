"""Checkpoint files → the port's pipeline.

Port of ``followyourclick_tpu/utils/loaders.py`` (the reference's assembly,
``scripts/inference.py:152-247``), for every dialect it reads:

- HF ``from_pretrained`` directories, one state dict a subfolder
  (``diffusion_pytorch_model.safetensors`` / ``.bin``, ``model.safetensors``
  / ``pytorch_model.bin``);
- DDP motion-module ``.ckpt`` pickles (``module.`` stripped, a
  ``{"state_dict": ...}`` wrapper unwrapped, loaded over the UNet);
- LDM full-SD ``.safetensors`` / ``.ckpt`` files (``utils/ldm.py``);
- LoRA files (``utils/lora.py``), IP-Adapter checkpoints, a T5 encoder dir.

``.safetensors`` files go through :func:`read_safetensors`, the port's own
reader (no ``safetensors`` package); pickles through
``torch.load(weights_only=True)``. State dicts become the JAX package's flax
trees by ``utils/convert.py`` and the modules take them by
``load_jax_params``; parameters a checkpoint lacks keep the port's own
initialisation (zero-initialised motion-module outputs stay zero).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from followyourclick_tpu_torch.utils.convert import (
    _to_numpy,
    audit_params,
    convert_clip_text_state_dict,
    convert_clip_vision_state_dict,
    convert_image_proj_state_dict,
    convert_resampler_state_dict,
    convert_unet3d_state_dict,
    convert_vae_state_dict,
    drop_paths,
    graft_ip_cross_attention,
    load_jax_params,
    merge_params,
    module_tree,
)

# the safetensors dtypes the reader takes
SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → ``{name: tensor}`` (CPU, the file's dtype,
    bit for bit), in sorted name order as the ``safetensors`` package lists
    them (a converter that maps two names to one leaf keeps the later). The
    format: an 8-byte little-endian header length, a JSON
    header ``{name: {dtype, shape, data_offsets}}`` (and an optional
    ``__metadata__``), then the raw little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    header.pop("__metadata__", None)
    for name, info in sorted(header.items()):
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             f"take ({sorted(SAFETENSORS_DTYPES)})")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, offset=start,
                                     count=(end - start) // dtype.itemsize
                                     ).reshape(shape)
    return out


def load_torch_file(path: str) -> Dict:
    """A ``.ckpt`` / ``.bin`` / ``.pt`` pickle or a ``.safetensors`` file →
    a flat numpy state dict, ``module.`` prefixes stripped and a
    ``{"state_dict": ...}`` wrapper unwrapped, as the JAX package reads it:
    pickled tensors as fp32, safetensors in their own dtype (bf16 as fp32,
    which numpy lacks)."""
    if path.endswith(".safetensors"):
        out = {}
        for k, v in read_safetensors(path).items():
            out[k] = (v.float().numpy() if v.dtype == torch.bfloat16
                      else v.numpy())
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        out = {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
               for k, v in raw.items()}
    return {k.removeprefix("module."): v for k, v in out.items()}


def load_hf_subfolder(model_dir: str, subfolder: str) -> Dict:
    """The state dict of one HF model subfolder (``vae``, ``unet``,
    ``text_encoder``; ``""`` for the directory itself)."""
    sub = os.path.join(model_dir, subfolder)
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        path = os.path.join(sub, name)
        if os.path.exists(path):
            return load_torch_file(path)
    raise FileNotFoundError(f"no weights found under {sub}")


def load_torch_file_nested(path: str) -> Dict:
    """A pickle with one level of nesting kept (the released IP-Adapter
    checkpoints are ``{"image_proj": {...}, "ip_adapter": {...}}``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def inflate_conv_in(unet_tree: Dict, target_in_channels: int) -> Dict:
    """Zero-pad the ``conv_in`` kernel's input-channel axis (the 2D → 3D
    inflation: the first 4 channels copied, the rest zero)."""
    node = unet_tree["conv_in"]["conv"]
    kernel = np.asarray(node["kernel"])  # (kh, kw, in, out)
    cur = kernel.shape[2]
    if cur == target_in_channels:
        return unet_tree
    assert cur < target_in_channels, (cur, target_in_channels)
    pad = np.zeros(kernel.shape[:2] + (target_in_channels - cur,)
                   + kernel.shape[3:], dtype=kernel.dtype)
    node["kernel"] = np.concatenate([kernel, pad], axis=2)
    return unet_tree


def load_partial(module: torch.nn.Module, converted: Dict, tag: str,
                 verbose: bool = True) -> tuple[list, list, list]:
    """Lay a converted (partial) tree over ``module``: audit it against the
    module's own tree, print the counts, refuse a mismatched leaf, fill the
    parameters it holds (unexpected leaves are dropped, the rest keep their
    values). Returns (missing, unexpected, mismatched)."""
    ref = module_tree(module)
    params = merge_params(ref, converted)
    missing, unexpected, mismatched = audit_params(params, ref)
    if verbose:
        print(f"[{tag}] missing={len(missing)} "
              f"unexpected={len(unexpected)} mismatched={len(mismatched)}")
    assert not mismatched, mismatched[:5]
    load_jax_params(module, drop_paths(converted, unexpected), partial=True)
    return missing, unexpected, mismatched


def load_unet3d_params(unet, sd_unet_state: Dict,
                       motion_module_state: Optional[Dict] = None,
                       verbose: bool = True) -> tuple[list, list, list]:
    """``from_pretrained_2d`` and the motion-module load into ``unet`` in
    place: the converted 2D weights (``conv_in`` inflated to the UNet's
    input channels), then the motion module's over them; audited as the
    JAX loader audits (``[load_unet3d] missing= unexpected= mismatched=``;
    a mismatch raises)."""
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel

    converted = inflate_conv_in(
        convert_unet3d_state_dict(sd_unet_state),
        UNet3DConditionModel.conv_in_channels(unet.config))
    if motion_module_state is not None:
        converted = merge_params(
            converted, convert_unet3d_state_dict(motion_module_state))
    return load_partial(unet, converted, "load_unet3d", verbose)


def default_dtype(device: torch.device | str) -> torch.dtype:
    """bf16 on the card, fp32 elsewhere (the JAX loader's "bf16 on the
    TPU")."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def assemble_pipeline_from_pretrained(
    pretrained_model_path: str,
    inference_config,
    motion_module_path: Optional[str] = None,
    personalized_ckpt_path: Optional[str] = None,
    lora_path: Optional[str] = None,
    lora_alpha: float = 0.6,
    motion_lora_path: Optional[str] = None,
    motion_lora_alpha: float = 1.0,
    dtype: Optional[torch.dtype] = None,
    ip_mode: str = "",
    image_encoder_path: Optional[str] = None,
    ip_ckpt_path: Optional[str] = None,
    t5_path: Optional[str] = None,
    device: torch.device | str = "cuda",
):
    """The reference assembly: an SD-1.5 directory → the 3D UNet (``conv_in``
    inflated) → the motion-module ``.ckpt`` over it → an optional
    personalized LDM checkpoint over the base → the SD and motion LoRA
    merges → the optional IP-Adapter (``ip_mode`` ``"raw"``/``"vanilla"``: 4
    tokens by ``ImageProjModel``; ``"plus"``: 16 by the Resampler) → the
    optional T5 tower → ``AnimationPipeline`` on ``device`` in ``dtype``
    (None: bf16 on the card, fp32 elsewhere). The modules are built and
    filled in fp32 on ``device``, the LoRA deltas added in fp32, then cast.
    The tokenizer is the port's CLIP tokenizer over
    ``tokenizer/merges.txt`` where that file exists, else None;
    ``tokenizer_2`` the port's T5 tokenizer where ``t5_path`` holds
    ``tokenizer.json`` or ``spiece.model``, else None (T5 requests then
    carry token ids through ``sample``)."""
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )
    from followyourclick_tpu_torch.utils import ldm as ldm_mod
    from followyourclick_tpu_torch.utils.lora import (
        merge_motion_lora,
        merge_sd_lora,
    )

    device = torch.device(device)
    if dtype is None:
        dtype = default_dtype(device)
    if ip_mode:
        num_tokens = 16 if ip_mode == "plus" else 4
        inference_config = dataclasses.replace(
            inference_config,
            unet=dataclasses.replace(inference_config.unet,
                                     use_ip_cross_attention=True,
                                     ip_num_tokens=num_tokens))

    sd_unet = load_hf_subfolder(pretrained_model_path, "unet")
    sd_vae = load_hf_subfolder(pretrained_model_path, "vae")
    sd_text = load_hf_subfolder(pretrained_model_path, "text_encoder")
    if personalized_ckpt_path:
        raw = load_torch_file(personalized_ckpt_path)
        sd_unet = ldm_mod.convert_ldm_unet(raw) or sd_unet
        sd_vae = ldm_mod.convert_ldm_vae(raw) or sd_vae
        sd_text = ldm_mod.convert_ldm_clip(raw) or sd_text

    mm_state = load_torch_file(motion_module_path) if motion_module_path \
        else None
    mm_image_proj = None
    if mm_state is not None:
        # the reference's ip weights ride in the motion-module ckpt; the
        # pipeline owns the projection model
        mm_image_proj = {
            k[len("image_proj_model."):]: v for k, v in mm_state.items()
            if k.startswith("image_proj_model.")}
        if mm_image_proj:
            mm_state = {k: v for k, v in mm_state.items()
                        if not k.startswith("image_proj_model.")}

    with torch.device(device):
        unet = UNet3DConditionModel(inference_config.unet)
        vae = AutoencoderKL(inference_config.vae)
        text = CLIPTextModel(inference_config.clip_text)
    load_unet3d_params(unet, sd_unet, mm_state)
    load_jax_params(vae, convert_vae_state_dict(sd_vae))
    load_jax_params(text, convert_clip_text_state_dict(sd_text))
    del sd_unet, sd_vae, sd_text, mm_state

    if lora_path:
        merge_sd_lora(unet, text, load_torch_file(lora_path), lora_alpha)
    if motion_lora_path:
        merge_motion_lora(unet, load_torch_file(motion_lora_path),
                          motion_lora_alpha)

    ip_adapter = None
    if ip_mode:
        ip_adapter = assemble_ip_adapter(
            inference_config, ip_mode, unet,
            image_encoder_path=image_encoder_path,
            ip_ckpt_path=ip_ckpt_path, mm_image_proj=mm_image_proj,
            device=device)

    t5 = tokenizer_2 = None
    if t5_path:
        from followyourclick_tpu_torch.models.t5_text import (
            T5Config,
            T5EncoderModel,
            convert_t5_state_dict,
            t5_config_from_hf,
        )

        cfg_file = os.path.join(t5_path, "config.json")
        t5_cfg = T5Config()
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                t5_cfg = t5_config_from_hf(json.load(f))
        with torch.device(device):
            t5 = T5EncoderModel(t5_cfg)
        load_jax_params(t5, convert_t5_state_dict(
            load_hf_subfolder(t5_path, "")))
        if any(os.path.exists(os.path.join(t5_path, name))
               for name in ("tokenizer.json", "spiece.model")):
            from followyourclick_tpu_torch.utils.t5_tokenizer import (
                T5Tokenizer,
            )

            tokenizer_2 = T5Tokenizer.from_pretrained(t5_path)

    tokenizer = None
    merges = os.path.join(pretrained_model_path, "tokenizer", "merges.txt")
    if os.path.exists(merges):
        from followyourclick_tpu_torch.utils.native_tokenizer import (
            NativeCLIPTokenizer,
        )

        tokenizer = NativeCLIPTokenizer(merges)

    return AnimationPipeline(inference_config, unet, vae, text,
                             device=device, dtype=dtype,
                             ip_adapter=ip_adapter, t5=t5,
                             tokenizer=tokenizer, tokenizer_2=tokenizer_2)


def assemble_ip_adapter(inference_config, ip_mode: str, unet,
                        image_encoder_path: Optional[str] = None,
                        ip_ckpt_path: Optional[str] = None,
                        mm_image_proj: Optional[Dict] = None,
                        device: torch.device | str = "cuda"):
    """The IP-Adapter (CLIP vision tower + projection, fp32 on ``device``)
    from whichever sources exist, in the reference's order: the vision
    tower from ``image_encoder_path``; a released ip checkpoint
    (``{"image_proj", "ip_adapter"}``: the projection, and the decoupled
    k/v weights grafted onto ``unet``'s ``to_k_ip`` / ``to_v_ip`` in place),
    else the motion-module checkpoint's ``image_proj_model.*``; what none
    holds keeps the port's initialisation. The JAX package's
    ``assemble_ip_adapter_params``, on modules."""
    from followyourclick_tpu_torch.models.ip_adapter import (
        CLIPVisionConfig,
        IPAdapter,
    )

    with torch.device(device):
        module = IPAdapter(
            CLIPVisionConfig(),
            cross_attention_dim=inference_config.unet.cross_attention_dim,
            num_tokens=inference_config.unet.ip_num_tokens,
            plus=(ip_mode == "plus"))
    if image_encoder_path:
        load_partial(module.image_encoder, convert_clip_vision_state_dict(
            load_hf_subfolder(image_encoder_path, "")), "image_encoder")

    proj_sd = None
    if ip_ckpt_path:
        state = load_torch_file_nested(ip_ckpt_path)
        proj_sd = {k: _to_numpy(v) for k, v in state["image_proj"].items()}
        graft_ip_unet(unet, state["ip_adapter"])
    elif mm_image_proj:
        proj_sd = mm_image_proj
    if proj_sd is not None:
        conv = (convert_resampler_state_dict if ip_mode == "plus"
                else convert_image_proj_state_dict)
        load_partial(module.image_proj_model, conv(proj_sd),
                     "image_proj_model")
    return module


def graft_ip_unet(unet, ip_state_dict) -> None:
    """``utils/convert.graft_ip_cross_attention`` on ``unet``'s module tree:
    the ip checkpoint's k/v weights into every ``to_k_ip`` / ``to_v_ip``."""
    grafted = graft_ip_cross_attention(module_tree(unet), ip_state_dict)

    def ip_only(tree):
        out = {}
        for k, v in tree.items():
            if k in ("to_k_ip", "to_v_ip"):
                out[k] = {"kernel": v["kernel"]}
            elif isinstance(v, dict):
                sub = ip_only(v)
                if sub:
                    out[k] = sub
        return out

    load_jax_params(unet, ip_only(grafted), partial=True)


def load_ip_adapter(ckpt_path_or_dict, unet, plus: bool = False) -> Dict:
    """A released IP-Adapter checkpoint (``{"image_proj": ...,
    "ip_adapter": ...}``): the k/v weights grafted onto ``unet`` in place;
    returns the projection model's flax tree."""
    state = (load_torch_file_nested(ckpt_path_or_dict)
             if isinstance(ckpt_path_or_dict, (str, bytes))
             else ckpt_path_or_dict)
    image_proj_sd = {k: _to_numpy(v) for k, v in state["image_proj"].items()}
    graft_ip_unet(unet, state["ip_adapter"])
    return (convert_resampler_state_dict(image_proj_sd) if plus
            else convert_image_proj_state_dict(image_proj_sd))
