"""LoRA merge at load: camera-motion (motion-module) LoRA and kohya SD LoRA.

Port of ``followyourclick_tpu/utils/lora.py`` (the reference's
``convert_lora_safetensor_to_diffusers.py``: ``W += α·up@down`` into the
named layer). The JAX package adds to a copy of its parameter tree; here the
merge writes into the port's modules in place, under ``torch.no_grad()``,
and returns them.

A key resolves to a module in two steps: the reference name to a flax path
(``utils/convert._map_unet_key``; kohya's underscore-flattened names by
greedy longest-prefix matching against the flax-name view of the module
tree, with the JAX renames), then the flax path to the module whose
``utils/convert._flax_path`` it is. The delta ``α·up@down`` is computed in
fp32 numpy and added in the parameter's dtype. The add is ``param.add_``, so
the parameter's version counter moves and every cache keyed on it
(``TemporalAttention.qkv_weight``) is rebuilt at its next use; a write
through ``param.data`` would leave the counter, and the bf16 kernels would
keep reading the unmerged ``[Wq; Wk; Wv]``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from followyourclick_tpu_torch.utils.convert import (
    _flax_path,
    _leaf_name,
    _map_unet_key,
    _to_numpy,
)


def _flax_view(module: nn.Module) -> Tuple[Dict, Dict]:
    """The module tree as the JAX package's nested parameter names (only
    nodes that hold parameters), and each flax module path's module."""
    tree: Dict = {}
    mods = {_flax_path(name): m for name, m in module.named_modules()}
    for name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            node = tree
            for seg in _flax_path(name):
                node = node.setdefault(seg, {})
            node[_leaf_name(mod, pname)] = pname
    return tree, mods


def _add_at(module: nn.Module, delta: np.ndarray) -> None:
    """``module.weight += delta`` (torch layout), in the weight's dtype."""
    weight = module.weight
    if isinstance(module, nn.Linear) and delta.ndim == 4:
        delta = delta[:, :, 0, 0]  # a 1x1-conv LoRA on a linear layer
    if tuple(delta.shape) != tuple(weight.shape):
        raise ValueError(f"LoRA delta {delta.shape} for a weight "
                         f"{tuple(weight.shape)}")
    weight.add_(torch.from_numpy(np.ascontiguousarray(delta)).to(
        device=weight.device, dtype=weight.dtype))


def merge_motion_lora(unet: nn.Module, state_dict: Mapping[str, object],
                      alpha: float = 1.0) -> nn.Module:
    """Merge a camera-motion LoRA into the UNet in place. Keys look like
    ``...attention_blocks.N.processor.to_q_lora.down.weight``; the target
    layer is the key without ``processor.``, ``_lora`` and ``down.`` /
    ``up.``."""
    _, mods = _flax_view(unet)
    with torch.no_grad():
        for key in state_dict:
            if "lora" not in key or ".up." in key:
                continue
            up_key = key.replace(".down.", ".up.")
            model_key = (key.replace("processor.", "").replace("_lora", "")
                         .replace("down.", "").replace("up.", "")
                         .replace("module.", ""))
            path = _map_unet_key(model_key)
            if path is None or path[-1] != "weight" or path[:-1] not in mods:
                raise KeyError(f"cannot resolve motion LoRA key {key!r}")
            down = _to_numpy(state_dict[key])
            up = _to_numpy(state_dict[up_key])
            _add_at(mods[path[:-1]], alpha * (up @ down))
    return unet


def _resolve_underscore_name(tree: Dict, flat: str) -> Tuple[str, ...]:
    """A kohya underscore-flattened module name → its flax path, by greedy
    longest-prefix matching at each level."""
    segments = flat.split("_")
    path = []
    node = tree
    i = 0
    while i < len(segments):
        match = None
        for j in range(len(segments), i, -1):
            cand = "_".join(segments[i:j])
            if isinstance(node, dict) and cand in node:
                match = (cand, j)
                break
        if match is None:
            options = list(node)[:8] if isinstance(node, dict) else "leaf"
            raise KeyError(f"cannot resolve '{flat}' at segment {i} "
                           f"(options: {options})")
        path.append(match[0])
        node = node[match[0]]
        i = match[1]
    return tuple(path)


# kohya name fragments renamed to the flax names before resolution
_KOHYA_RENAMES = (
    ("_to_out_0", "_to_out"),
    ("_ff_net_0_proj", "_ff_proj"),
    ("_ff_net_2", "_ff_out"),
    ("_text_model", ""),
)


def merge_sd_lora(unet: nn.Module, text_encoder: Optional[nn.Module],
                  state_dict: Mapping[str, object], alpha: float = 0.6
                  ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """Merge a kohya SD LoRA (``lora_unet_*`` / ``lora_te_*``) into the UNet
    and the CLIP text encoder in place (``lora_te_*`` keys are skipped
    without one). A name that resolves to no module with a kernel raises
    ``KeyError``."""
    views = {"unet": _flax_view(unet)}
    if text_encoder is not None:
        views["te"] = _flax_view(text_encoder)
    visited = set()
    with torch.no_grad():
        for key in state_dict:
            if ".alpha" in key or key in visited or "lora_down" not in key:
                continue
            up_key = key.replace("lora_down", "lora_up")
            visited.update((key, up_key))
            flat = key.split(".")[0]
            if flat.startswith("lora_te_"):
                if "te" not in views:
                    continue
                name = flat[len("lora_te_"):]
                for old, new in _KOHYA_RENAMES:
                    name = name.replace(old, new)
                name = name.removeprefix("text_model_")
                name = name.replace("encoder_layers_", "layers_")
                tree, mods = views["te"]
            elif flat.startswith("lora_unet_"):
                name = flat[len("lora_unet_"):]
                for old, new in _KOHYA_RENAMES:
                    name = name.replace(old, new)
                tree, mods = views["unet"]
            else:
                continue
            path = _resolve_underscore_name(tree, name)
            node = tree
            for seg in path:
                node = node[seg]
            if not isinstance(node, dict) or "kernel" not in node:
                raise KeyError(f"no kernel at {path}")
            down = _to_numpy(state_dict[key])
            up = _to_numpy(state_dict[up_key])
            if down.ndim == 4:  # conv: down (r, in, kh, kw), up (out, r, 1, 1)
                delta = np.einsum("or,rihw->oihw", up[:, :, 0, 0], down)
            else:
                delta = up @ down
            _add_at(mods[path], alpha * delta)
    return unet, text_encoder
