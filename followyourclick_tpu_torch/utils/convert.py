"""Parameter bridge: a flax parameter tree of the JAX package → a torch module.

The port names its submodules after the JAX package's flax modules, so one
rule maps every path: a torch name segment that is an index of a
``ModuleList`` (``down_blocks.0``) is the flax name ``down_blocks_0``, and
every other segment is the same word. Leaves are renamed and re-laid per
torch module kind:

- ``nn.Linear``: ``kernel (in, out)`` → ``weight (out, in)``; a 1×1-conv
  kernel ``(1, 1, in, out)`` is accepted too (the JAX ``Conv1x1``);
- ``nn.Conv2d``: ``kernel HWIO`` → ``weight OIHW``;
- ``nn.Conv1d`` (a conv along the frames): ``kernel (K, in, out)`` →
  ``weight (out, in, K)``;
- ``nn.Embedding``: ``embedding`` → ``weight``;
- norms (any other module with ``weight``): ``scale`` → ``weight``;
- ``bias`` stays ``bias``; a module may declare raw parameters under other
  names (kept as they are, same shape): the CLIP vision tower's
  ``class_embedding`` and the Resampler's ``latents``.

A flax module name that holds underscores and digits but is no list entry
(the Resampler's ``layers_0_attn``) is registered under that same name on
the torch side (``models/ip_adapter.py``), so it maps to itself; a
``ModuleList`` entry ``layers.0.attn`` would map to ``layers_0/attn``.

Real checkpoints go reference ``.ckpt`` → ``followyourclick_tpu.utils.
convert.convert_*_state_dict`` (numpy, no JAX) → :func:`load_jax_params`.
:func:`_map_unet_key` and :func:`_to_numpy` are the port's own copies of
that module's reference-name rule, which ``utils/lora.py`` resolves LoRA
keys through.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _to_numpy(t) -> np.ndarray:
    """A torch tensor (as fp32) or an array-like as a numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t)


_LIST_MODULES = (
    "down_blocks|up_blocks|resnets|attentions|motion_modules|"
    "transformer_blocks|attention_blocks|norms|downsamplers|upsamplers"
)
# buffers the modules recompute
_SKIP_PATTERNS = (
    re.compile(r"pos_encoder\.pe$"),
    re.compile(r"rope\."),
    re.compile(r"position_ids$"),
)
# convs that wrap an inner conv named "conv"
_INFLATED_CONVS = re.compile(
    r"(^|\.)(conv_in|conv_out|conv1|conv2|conv_shortcut)$")


def _map_unet_key(key: str) -> tuple | None:
    """A reference UNet3D state-dict name → its flax path, leaf name last
    (``weight`` / ``bias`` as in the reference); None for a recomputed
    buffer. The reference's ``temporal_transformer`` level is dropped,
    ``to_out.0`` is ``to_out``, ``ff.net.0.proj`` / ``ff.net.2`` are
    ``ff.proj`` / ``ff.out``, list indices fold into the module name, and an
    inflated conv gains its inner ``conv``."""
    for pat in _SKIP_PATTERNS:
        if pat.search(key):
            return None
    parts = key.split(".")
    leaf = parts.pop()
    name = ".".join(parts)
    name = name.replace(".temporal_transformer.", ".")
    name = re.sub(r"\.to_out\.0$", ".to_out", name)
    name = re.sub(r"\.ff\.net\.0\.proj$", ".ff.proj", name)
    name = re.sub(r"\.ff\.net\.2$", ".ff.out", name)
    name = re.sub(rf"\b({_LIST_MODULES})\.(\d+)", r"\1_\2", name)
    parts = name.split(".")
    if _INFLATED_CONVS.search(parts[-1]):
        parts = parts + ["conv"]
    return tuple(parts) + (leaf,)


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _flax_path(torch_name: str) -> tuple:
    """``down_blocks.0.resnets.1.norm1`` → ``(down_blocks_0, resnets_1, norm1)``."""
    segs: list[str] = []
    for s in torch_name.split(".") if torch_name else []:
        if s.isdigit() and segs:
            segs[-1] = f"{segs[-1]}_{s}"
        else:
            segs.append(s)
    return tuple(segs)


def _leaf_name(module: nn.Module, pname: str) -> str:
    """The flax leaf that fills torch parameter ``pname`` of ``module``."""
    if pname != "weight":
        return pname
    if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return "kernel"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return "scale"


def _torch_layout(module: nn.Module, pname: str,
                  value: np.ndarray) -> np.ndarray:
    if pname != "weight":
        return value
    if isinstance(module, nn.Linear):
        if value.ndim == 4:  # Conv1x1 kernel (1, 1, in, out)
            value = value[0, 0]
        return value.T
    if isinstance(module, nn.Conv2d):
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if isinstance(module, nn.Conv1d):
        return value.transpose(2, 1, 0)  # (K, in, out) -> (out, in, K)
    return value


def pab_cache_from_jax(tree: Mapping[str, Any]) -> dict:
    """A JAX ``"pab"`` collection (nested dicts of numpy arrays) → the
    port's PAB cache (``models/pab.py``): the path ``(down_blocks_0,
    attentions_0, ..., attn1_out)`` becomes the key
    ``down_blocks.0.attentions.0....attn1_out``. Every module segment of a
    site path is a ``ModuleList`` entry or a plain name; the last segment is
    the site's name and stays as it is."""
    out = {}
    for path, value in _flatten(tree).items():
        mods = [re.sub(r"_(\d+)$", r".\1", seg) for seg in path[:-1]]
        out[".".join(mods + [path[-1]])] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return out


def load_jax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``module``'s parameters from a flax parameter tree (nested dicts
    of numpy arrays) in place. Raises on any leaf left unused, any parameter
    left unfilled, and any shape mismatch."""
    src = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    used = set()
    unfilled = []
    with torch.no_grad():
        for mname, mod in module.named_modules():
            base = _flax_path(mname)
            for pname, param in mod.named_parameters(recurse=False):
                key = base + (_leaf_name(mod, pname),)
                if key not in src:
                    unfilled.append(f"{mname}.{pname}")
                    continue
                value = _torch_layout(mod, pname, src[key])
                if tuple(value.shape) != tuple(param.shape):
                    raise ValueError(
                        f"{mname}.{pname}: shape {tuple(param.shape)} vs "
                        f"{'/'.join(key)} {value.shape}")
                param.copy_(torch.from_numpy(
                    np.ascontiguousarray(value, dtype=np.float32)).to(
                        param.dtype))
                used.add(key)
    unused = sorted("/".join(k) for k in src if k not in used)
    if unfilled or unused:
        raise ValueError(f"load_jax_params: unfilled torch parameters "
                         f"{unfilled[:20]}; unused flax leaves {unused[:20]} "
                         f"({len(unfilled)} unfilled, {len(unused)} unused)")
    return module
