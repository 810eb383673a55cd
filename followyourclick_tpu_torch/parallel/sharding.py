"""Parameter partitioning over the ``model`` axis: the port of
``followyourclick_tpu/parallel/sharding.py``.

The JAX package gives every leaf a ``PartitionSpec`` by its flax path
(Megatron-style, ``_spec_for``): the q/k/v kernels (``to_k_ip`` /
``to_v_ip``, the VAE's ``query`` / ``key`` / ``value``) and the GEGLU
in-projection split on their output dimension, the attention
out-projections (``to_out``, ``proj_attn``) and the GEGLU out-projection on
their input dimension, the column-parallel biases with their kernels, and
every conv, norm, embedding and other leaf replicated.
:func:`param_sharding_rules` gives each torch parameter the spec JAX gives
its flax counterpart (``utils/convert.flax_paths``), in torch layout: a
JAX ``P(None, 'model')`` on an ``(in, out)`` kernel is ``('model', None)``
on the ``(out, in)`` weight, ``P('model', None)`` is ``(None, 'model')``.

:func:`shard_params` keeps each rank's slice of every split leaf in the
module and tells the modules that run them (``CrossAttention``,
``GEGLUFeedForward``, ``TemporalAttention`` and its block,
``VAEAttentionBlock``) the mesh, so a sharded model is a normal
``nn.Module`` that runs on its slices (``parallel/tensor_parallel.py``).
The GEGLU in-projection ``[W_h; W_gate]`` is split half by half: a rank
keeps its rows of ``W_h`` and the same rows of ``W_gate``, so
``proj(x).chunk(2)`` gives it matching h and gate columns (a plain split
of the stacked rows would give rank 0 all of h and rank 1 all of the gate;
GSPMD reshards that case, the port slices each half).
:func:`gather_params` rebuilds the full tensors (checkpoints, tests).

``batch_sharding`` (``P("data")``) is :func:`shard_batch`: the data rank's
rows (``parallel/data_parallel.shard_rows``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from followyourclick_tpu_torch.models.attention import (
    CrossAttention,
    GEGLUFeedForward,
)
from followyourclick_tpu_torch.models.motion_module import (
    TemporalAttention,
    TemporalTransformerBlock,
)
from followyourclick_tpu_torch.models.vae import VAEAttentionBlock
from followyourclick_tpu_torch.parallel.data_parallel import shard_rows
from followyourclick_tpu_torch.parallel.tensor_parallel import all_gather
from followyourclick_tpu_torch.utils.convert import _jax_shape, flax_paths

# projections whose OUTPUT dim shards over 'model'
_COL_PARALLEL = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip",
                 "q_proj", "k_proj", "v_proj", "mlp_fc1", "query", "key",
                 "value")
# projections whose INPUT dim shards over 'model'
_ROW_PARALLEL = ("to_out", "out_proj", "mlp_fc2", "proj_attn")

Spec = Tuple[Optional[str], ...]


def _jax_spec(path: Tuple[str, ...], ndim: int) -> Spec:
    """JAX ``_spec_for`` on a flax path and its leaf's rank, as a tuple."""
    leaf_name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    grandparent = path[-3] if len(path) >= 3 else ""
    if leaf_name == "kernel" and ndim == 2:
        if parent in _COL_PARALLEL:
            return (None, "model")
        if parent in _ROW_PARALLEL:
            return ("model", None)
        if parent == "proj" and grandparent == "ff":
            return (None, "model")   # GEGLU in-projection
        if parent == "out" and grandparent == "ff":
            return ("model", None)   # GEGLU out-projection
        return (None, None)
    if leaf_name == "bias" and ndim == 1:
        if parent in _COL_PARALLEL or (parent == "proj"
                                       and grandparent == "ff"):
            return ("model",)
        return (None,)
    return (None,) * ndim


def param_sharding_rules(module: nn.Module) -> dict:
    """Torch parameter name → the JAX spec of its flax counterpart, in
    torch layout (a linear weight's two axes swapped)."""
    paths = flax_paths(module)
    rules = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            path = paths[name]
            spec = _jax_spec(path, len(_jax_shape(mod, p)))
            if path[-1] == "kernel" and len(spec) == 2:
                spec = spec[::-1]
            rules[name] = spec
    return rules


def _halves(name: str) -> int:
    """2 for a GEGLU in-projection (``…ff.proj``), whose rows are
    ``[W_h; W_gate]``, else 1."""
    return 2 if name.rsplit(".", 1)[0].endswith("ff.proj") else 1


def split_specs(rules: Mapping[str, Spec]) -> dict:
    """Name → ``(dim, halves)`` of every split leaf of ``rules``."""
    return {n: (spec.index("model"), _halves(n))
            for n, spec in rules.items() if "model" in spec}


def local_slice(t: torch.Tensor, dim: int, halves: int, rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s slice of the full ``t`` along ``dim``,
    each of its ``halves`` split alike."""
    if t.shape[dim] % (halves * size):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {halves} x {size}")
    n = t.shape[dim] // (halves * size)
    return torch.cat([h.narrow(dim, rank * n, n)
                      for h in t.chunk(halves, dim)], dim)


def gather_slices(local: torch.Tensor, dim: int, halves: int,
                  mesh) -> torch.Tensor:
    """The full tensor from every model rank's :func:`local_slice`."""
    parts = [p.chunk(halves, dim)
             for p in all_gather(local.contiguous(), mesh.model_group)]
    return torch.cat([torch.cat([p[h] for p in parts], dim)
                      for h in range(halves)], dim)


def shard_tensors(tensors: Mapping[str, torch.Tensor], specs: Mapping,
                  mesh) -> dict:
    """Each full tensor of ``tensors`` as this model rank's slice where
    ``specs`` (:func:`split_specs`) splits it."""
    return {n: local_slice(t, *specs[n], mesh.model_rank, mesh.model_size)
            if n in specs else t for n, t in tensors.items()}


def gather_tensors(tensors: Mapping[str, torch.Tensor], specs: Mapping,
                   mesh) -> dict:
    """The inverse of :func:`shard_tensors` (every model rank calls it)."""
    return {n: gather_slices(t, *specs[n], mesh) if n in specs else t
            for n, t in tensors.items()}


# the modules with a tensor-parallel forward (their ``tp`` attribute)
TP_MODULES = (CrossAttention, GEGLUFeedForward, TemporalAttention,
              TemporalTransformerBlock, VAEAttentionBlock)


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Keep this model rank's slice of every split parameter of
    ``module`` (in place; returns it) and give the modules that run them
    the mesh. A mesh with one model rank changes nothing; a module sharded
    already is returned as it is. Raises where a split leaf belongs to a
    module that cannot run on a slice."""
    if mesh is None or mesh.model_size == 1 \
            or getattr(module, "_tp_mesh", None) is not None:
        return module
    owners = dict(module.named_modules())
    specs = split_specs(param_sharding_rules(module))
    for name, (dim, halves) in specs.items():
        mname, pname = name.rsplit(".", 1)
        parent = owners.get(mname.rsplit(".", 1)[0]) if "." in mname \
            else module
        if not isinstance(parent, TP_MODULES):
            raise NotImplementedError(
                f"{name} splits over 'model' but its module "
                f"{type(parent).__name__} has no tensor-parallel forward")
        lin = owners[mname]
        p = getattr(lin, pname)
        local = local_slice(p.detach(), dim, halves, mesh.model_rank,
                            mesh.model_size)
        setattr(lin, pname, nn.Parameter(local.clone(),
                                         requires_grad=p.requires_grad))
        if isinstance(lin, nn.Linear) and pname == "weight":
            lin.out_features, lin.in_features = local.shape
    for m in module.modules():
        if isinstance(m, TP_MODULES):
            m.tp = mesh
    module._tp_mesh = mesh
    return module


def gather_params(module: nn.Module, mesh=None) -> dict:
    """Name → the full tensor of every parameter of a module sharded by
    :func:`shard_params` (every model rank calls it); the parameters of an
    unsharded module as they are."""
    mesh = getattr(module, "_tp_mesh", None) if mesh is None else mesh
    params = {n: p.detach() for n, p in module.named_parameters()}
    if getattr(module, "_tp_mesh", None) is None:
        return params
    return gather_tensors(params, split_specs(param_sharding_rules(module)),
                          mesh)


def shard_batch(x, mesh):
    """The data rank's rows of ``x`` (JAX ``batch_sharding``, ``P("data")``:
    a tensor or a dataclass of tensors)."""
    if mesh is None or mesh.data_size == 1:
        return x
    return shard_rows(x, mesh.data_rank, mesh.data_size)
