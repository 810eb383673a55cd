"""Parameter bridge: a flax parameter tree of the JAX package → a torch module.

The port names its submodules after the JAX package's flax modules, so one
rule maps every path: a torch name segment that is an index of a
``ModuleList`` (``down_blocks.0``) is the flax name ``down_blocks_0``, and
every other segment is the same word. Leaves are renamed and re-laid per
torch module kind:

- ``nn.Linear``: ``kernel (in, out)`` → ``weight (out, in)``; a 1×1-conv
  kernel ``(1, 1, in, out)`` is accepted too (the JAX ``Conv1x1``);
- ``nn.Conv2d``: ``kernel HWIO`` → ``weight OIHW``;
- ``nn.Embedding``: ``embedding`` → ``weight``;
- norms (any other module with ``weight``): ``scale`` → ``weight``;
- ``bias`` stays ``bias``; a module may declare raw parameters under other
  names (kept as they are, same shape).

Real checkpoints go reference ``.ckpt`` → ``followyourclick_tpu.utils.
convert.convert_*_state_dict`` (numpy, no JAX) → :func:`load_jax_params`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


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
    if isinstance(module, (nn.Linear, nn.Conv2d)):
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
    return value


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
