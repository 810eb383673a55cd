"""Flow weights: checkpoints in, JAX variables across.

The port's RAFT / GMA carry mmflow's state-dict names (``flow/raft.py``),
the other estimators the JAX module names, so
:func:`load_mmflow_raft_checkpoint` is a strict ``load_state_dict`` of the
file's ``state_dict`` (``torch.load`` with ``weights_only=True``) for any
of them. :func:`flow_state_from_jax` lays a JAX tree (``params`` and, for
RAFT, ``batch_stats``; numpy leaves) out under the port's names; the
tests carry weights across with it. For RAFT the name map is the JAX
package's ``flow/convert.convert_mmflow_raft`` read the other way, plus
GMA's heads (:func:`raft_state_from_jax`); for the others a state-dict
name is the flax path, ``weight`` read as ``kernel``. Conv kernels
``(kh, kw, in, out)`` become ``(out, in, kh, kw)``; flax's
``ConvTranspose(transpose_kernel=True)`` stores ``(kh, kw, out, in)``,
which the same transpose makes ``nn.ConvTranspose2d``'s ``(in, out, kh,
kw)``, unflipped.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# port name (without the tensor's own name) → JAX module path, in order
_RULES = (
    (r"\.res_layer(\d)\.(\d)\.", r".layer\1_\2."),
    (r"\.bn(\d)$", r".norm\1"),
    (r"\.downsample\.0$", ".downsample_conv"),
    (r"\.downsample\.1$", ".downsample_norm"),
    (r"^decoder\.encoder\.corr_net\.(\d)\.conv$",
     lambda m: f"decoder.encoder.corr_conv{int(m[1]) + 1}"),
    (r"^decoder\.encoder\.flow_net\.(\d)\.conv$",
     lambda m: f"decoder.encoder.flow_conv{int(m[1]) + 1}"),
    (r"^decoder\.encoder\.out_net\.0\.conv$", "decoder.encoder.out_conv"),
    (r"^decoder\.gru\.conv_(\w)\.(\d)\.conv$", r"decoder.gru.conv_\1\2"),
    (r"\.layers\.0\.conv$", ".conv"),
    (r"\.predict_layer$", ".predict"),
)


def _jax_path(name: str, module: nn.Module) -> Tuple[str, Tuple[str, ...]]:
    """(collection, path) of the JAX leaf behind the port's state-dict
    entry ``name`` of ``module`` (a ``RAFT``)."""
    owner, _, leaf = name.rpartition(".")
    path = owner
    for pattern, repl in _RULES:
        path = re.sub(pattern, repl, path)
    path = tuple(path.split("."))
    mod = module.get_submodule(owner) if owner else module
    if isinstance(mod, nn.GroupNorm):
        return "params", path + ("GroupNorm_0",
                                 {"weight": "scale", "bias": "bias"}[leaf])
    if isinstance(mod, nn.BatchNorm2d):
        if leaf in ("running_mean", "running_var"):
            return "batch_stats", path + ("BatchNorm_0", leaf[8:])
        return "params", path + ("BatchNorm_0",
                                 {"weight": "scale", "bias": "bias"}[leaf])
    if leaf == "gamma":
        return "params", path + ("gamma",)
    return "params", path + ({"weight": "kernel", "bias": "bias"}[leaf],)


def _named_path(name: str, module: nn.Module) -> Tuple[str, Tuple[str, ...]]:
    """(collection, path) of the JAX leaf behind ``name`` in an estimator
    whose submodules carry the flax names."""
    *path, leaf = name.split(".")
    return "params", tuple(path) + ({"weight": "kernel"}.get(leaf, leaf),)


def raft_state_from_jax(variables: Mapping[str, Any],
                        module: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`flow_state_from_jax` of a ``RAFT`` (or GMA)."""
    return flow_state_from_jax(variables, module)


def flow_state_from_jax(variables: Mapping[str, Any],
                        module: nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict of ``module`` (an estimator of the same config)
    holding the JAX tree ``variables``: conv kernels (kh, kw, in, out) →
    (out, in, kh, kw); BN ``num_batches_tracked`` kept as the module has
    it."""
    from followyourclick_tpu_torch.flow.raft import RAFT

    locate = _jax_path if isinstance(module, RAFT) else _named_path
    out = {}
    for name, ref in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = ref.clone()
            continue
        collection, path = locate(name, module)
        value = variables[collection]
        for key in path:
            value = value[key]
        value = np.array(value, np.float32)
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.ascontiguousarray(value)).reshape(
            ref.shape)
    return out


def load_mmflow_raft_checkpoint(path: str, module: nn.Module) -> nn.Module:
    """Load a ``.pth`` (``{"state_dict": ...}`` or the bare dict; mmflow's
    for RAFT / GMA) into ``module`` strictly; returns the module."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state.get("state_dict", state), strict=True)
    return module
