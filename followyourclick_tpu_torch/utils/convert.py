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

Real checkpoints go state dict (``utils/loaders.py``) →
``convert_*_state_dict`` → :func:`load_jax_params`. The converters are the
port's own numpy copies of those of ``followyourclick_tpu/utils/convert.py``
and give the same flax trees, so one key mapping serves both packages:
:func:`_map_unet_key` (which ``utils/lora.py`` also resolves LoRA keys
through), :func:`_map_vae_key` and :func:`_map_clip_key`. Value transforms
go by rank: rank 1 → norm ``scale`` / ``bias`` as they are, rank 2 linear →
transposed ``kernel``, rank 3 conv1d → ``(k, in, out)``, rank 4 conv2d →
``(kh, kw, in, out)``.

:func:`module_tree` is a module's own tree (:class:`ParamSlot` leaves, the
JAX layout's shapes): the reference tree of :func:`audit_params` and the
base that :func:`merge_params` lays a partial checkpoint over, as the JAX
loaders use a model's initialised parameters; ``load_jax_params(...,
partial=True)`` then fills only what the checkpoint holds.

The way back: :func:`flax_paths` gives each torch parameter name its flax
path (the training mask is decided on those), and :func:`export_jax_params`
writes a module's tensors, or a train state's, as a flax tree of numpy
arrays that :func:`load_jax_params` and the JAX package read.
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


def _leaf(name: str, tensor: np.ndarray) -> tuple:
    """A reference parameter leaf → (flax leaf name, value in flax layout)."""
    if name == "bias":
        return "bias", tensor
    if name != "weight":
        return name, tensor
    if tensor.ndim == 1:
        return "scale", tensor
    if tensor.ndim == 2:
        return "kernel", tensor.T
    if tensor.ndim == 3:  # conv1d (out, in, k) -> (k, in, out)
        return "kernel", tensor.transpose(2, 1, 0)
    if tensor.ndim == 4:  # conv2d (out, in, kh, kw) -> (kh, kw, in, out)
        return "kernel", tensor.transpose(2, 3, 1, 0)
    raise ValueError(f"unhandled weight rank {tensor.ndim} for {name}")


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_unet3d_state_dict(state_dict: Mapping[str, object],
                              use_pseudo_conv3d: bool = False) -> dict:
    """A reference UNet3D (or SD UNet2D) state dict → the flax tree. DDP
    ``module.`` prefixes are stripped; recomputed buffers are skipped."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        path = _map_unet_key(key.removeprefix("module."))
        if path is None:
            continue
        leaf_name, value = _leaf(path[-1], _to_numpy(tensor))
        full = path[:-1] + (leaf_name,)
        if use_pseudo_conv3d:
            full = tuple("spatial_conv" if p == "conv" else p for p in full)
        _set(tree, full, value)
    return tree


def _map_vae_key(key: str) -> tuple:
    """A diffusers ``AutoencoderKL`` name → its flax path, leaf last."""
    parts = key.split(".")
    leaf = parts.pop()
    name = ".".join(parts)
    name = re.sub(r"(encoder)\.down_blocks\.(\d+)\.resnets\.(\d+)",
                  r"\1.down_\2_resnet_\3", name)
    name = re.sub(r"(encoder)\.down_blocks\.(\d+)\.downsamplers\.0\.conv",
                  r"\1.down_\2_downsample", name)
    name = re.sub(r"(decoder)\.up_blocks\.(\d+)\.resnets\.(\d+)",
                  r"\1.up_\2_resnet_\3", name)
    name = re.sub(r"(decoder)\.up_blocks\.(\d+)\.upsamplers\.0\.conv",
                  r"\1.up_\2_upsample", name)
    name = re.sub(r"mid_block\.resnets\.(\d+)",
                  lambda m: f"mid_resnet_{int(m.group(1)) + 1}", name)
    name = name.replace("mid_block.attentions.0", "mid_attn_1")
    return tuple(name.split(".")) + (leaf,)


def convert_vae_state_dict(state_dict: Mapping[str, object]) -> dict:
    """A diffusers ``AutoencoderKL`` state dict → the flax tree. The
    attention's q/k/v/out as 1×1 convs (older LDM dumps) become linear
    kernels."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        path = _map_vae_key(key.removeprefix("module."))
        arr = _to_numpy(tensor)
        if path[-1] == "weight" and arr.ndim == 4 and arr.shape[2:] == (1, 1) \
                and path[-2] in ("query", "key", "value", "proj_attn"):
            arr = arr[:, :, 0, 0]
        leaf_name, value = _leaf(path[-1], arr)
        _set(tree, path[:-1] + (leaf_name,), value)
    return tree


def _map_clip_key(key: str) -> tuple | None:
    """An HF ``CLIPTextModel`` name → its flax path, leaf last."""
    if key.endswith("position_ids"):
        return None
    parts = key.split(".")
    leaf = parts.pop()
    name = ".".join(parts)
    name = re.sub(r"^text_model\.", "", name)
    name = re.sub(r"encoder\.layers\.(\d+)", r"layers_\1", name)
    name = name.replace("embeddings.token_embedding", "token_embedding")
    name = name.replace("embeddings.position_embedding", "position_embedding")
    name = name.replace("mlp.fc1", "mlp_fc1").replace("mlp.fc2", "mlp_fc2")
    return tuple(name.split(".")) + (leaf,)


def convert_clip_text_state_dict(state_dict: Mapping[str, object]) -> dict:
    """An HF ``CLIPTextModel`` state dict → the flax tree."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        path = _map_clip_key(key)
        if path is None:
            continue
        arr = _to_numpy(tensor)
        if path[-2] in ("token_embedding", "position_embedding"):
            _set(tree, path[:-1] + ("embedding",), arr)
            continue
        leaf_name, value = _leaf(path[-1], arr)
        _set(tree, path[:-1] + (leaf_name,), value)
    return tree


def audit_params(converted: Mapping, reference_tree: Mapping,
                 prefix: str = "") -> tuple[list, list, list]:
    """(missing, unexpected, mismatched) paths of ``converted`` against
    ``reference_tree``: a key missing or unexpected counts where it first
    appears, a leaf whose shape does not fit the reference leaf (a
    :class:`ParamSlot` decides itself what fits) is mismatched."""
    missing, unexpected, mismatched = [], [], []

    def walk(conv, ref, path):
        if not isinstance(ref, Mapping):
            if not hasattr(conv, "shape"):
                mismatched.append((path, "leaf-vs-tree"))
            elif not (ref.fits(conv) if isinstance(ref, ParamSlot)
                      else tuple(conv.shape) == tuple(ref.shape)):
                mismatched.append((path, tuple(conv.shape),
                                   tuple(ref.shape)))
            return
        if not isinstance(conv, Mapping):
            mismatched.append((path, "tree-vs-leaf"))
            return
        for k in set(ref) - set(conv):
            missing.append(path + (k,))
        for k in set(conv) - set(ref):
            unexpected.append(path + (k,))
        for k in set(ref) & set(conv):
            walk(conv[k], ref[k], path + (k,))

    walk(converted, reference_tree, (prefix,) if prefix else ())
    return missing, unexpected, mismatched


def merge_params(base: Mapping, overlay: Mapping) -> dict:
    """``overlay`` laid recursively over a copy of ``base`` (a partial
    checkpoint over a full tree)."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge_params(out[k], v)
        else:
            out[k] = v
    return out


def drop_paths(tree: Mapping, paths) -> dict:
    """A copy of ``tree`` without the subtrees at ``paths`` (what
    :func:`audit_params` calls unexpected)."""
    out = {k: drop_paths(v, ()) if isinstance(v, Mapping) else v
           for k, v in tree.items()}
    for path in paths:
        node = out
        for p in path[:-1]:
            node = node[p]
        node.pop(path[-1], None)
    return out


def convert_image_proj_state_dict(state_dict: Mapping[str, object]) -> dict:
    """The vanilla ``ImageProjModel`` state dict (proj linear, norm LN) →
    the flax tree."""
    return {
        "proj": {"kernel": _to_numpy(state_dict["proj.weight"]).T,
                 "bias": _to_numpy(state_dict["proj.bias"])},
        "norm": {"scale": _to_numpy(state_dict["norm.weight"]),
                 "bias": _to_numpy(state_dict["norm.bias"])},
    }


def convert_resampler_state_dict(state_dict: Mapping[str, object]) -> dict:
    """The Plus ``Resampler`` state dict (latents, proj_in / proj_out,
    norm_out, ``layers.{i}.0`` the perceiver attention, ``layers.{i}.1`` the
    LN → linear → GELU → linear feed-forward) → the flax tree."""
    sd = state_dict

    def lin(key):
        return _to_numpy(sd[key]).T

    def ln(prefix):
        return {"scale": _to_numpy(sd[f"{prefix}.weight"]),
                "bias": _to_numpy(sd[f"{prefix}.bias"])}

    tree: dict = {
        "latents": _to_numpy(sd["latents"]),
        "proj_in": {"kernel": lin("proj_in.weight"),
                    "bias": _to_numpy(sd["proj_in.bias"])},
        "proj_out": {"kernel": lin("proj_out.weight"),
                     "bias": _to_numpy(sd["proj_out.bias"])},
        "norm_out": ln("norm_out"),
    }
    depth = 0
    while f"layers.{depth}.0.to_q.weight" in sd:
        p = f"layers.{depth}"
        tree[f"layers_{depth}_attn"] = {
            "norm1": ln(f"{p}.0.norm1"), "norm2": ln(f"{p}.0.norm2"),
            "to_q": {"kernel": lin(f"{p}.0.to_q.weight")},
            "to_kv": {"kernel": lin(f"{p}.0.to_kv.weight")},
            "to_out": {"kernel": lin(f"{p}.0.to_out.weight")},
        }
        tree[f"layers_{depth}_ff_norm"] = ln(f"{p}.1.0")
        tree[f"layers_{depth}_ff_in"] = {"kernel": lin(f"{p}.1.1.weight")}
        tree[f"layers_{depth}_ff_out"] = {"kernel": lin(f"{p}.1.3.weight")}
        depth += 1
    return tree


def convert_clip_vision_state_dict(state_dict: Mapping[str, object]) -> dict:
    """A transformers ``CLIPVisionModelWithProjection`` state dict → the
    flax tree of ``models/ip_adapter.CLIPVisionModel``."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        arr = _to_numpy(tensor)
        k = key.replace("vision_model.", "")
        if k == "embeddings.class_embedding":
            _set(tree, ("class_embedding",), arr)
        elif k == "embeddings.patch_embedding.weight":
            _set(tree, ("patch_embedding", "kernel"),
                 arr.transpose(2, 3, 1, 0))
        elif k == "embeddings.position_embedding.weight":
            _set(tree, ("position_embedding", "embedding"), arr)
        elif k == "visual_projection.weight":
            _set(tree, ("visual_projection", "kernel"), arr.T)
        elif k.startswith(("pre_layrnorm", "post_layernorm")):
            mod, leaf = k.split(".")
            _set(tree, (mod, "scale" if leaf == "weight" else "bias"), arr)
        elif k.startswith("encoder.layers."):
            parts = k.split(".")
            idx, rest = parts[2], parts[3:]
            if rest[0] == "self_attn":
                mod = rest[1]
            elif rest[0] == "mlp":
                mod = {"fc1": "mlp_fc1", "fc2": "mlp_fc2"}[rest[1]]
            else:
                mod = rest[0]  # layer_norm1 / layer_norm2
            leaf = rest[-1]
            if mod.startswith("layer_norm"):
                _set(tree, (f"layers_{idx}", mod,
                            "scale" if leaf == "weight" else "bias"), arr)
            else:
                name, val = _leaf(leaf, arr)
                _set(tree, (f"layers_{idx}", mod, name), val)
    return tree


def graft_ip_cross_attention(unet_params: Mapping,
                             ip_state_dict: Mapping[str, object]) -> dict:
    """A copy of ``unet_params`` with the ip checkpoint's decoupled k/v
    weights on every ``to_k_ip`` / ``to_v_ip`` kernel, by position: the
    checkpoint's ``_ip`` tensors in their key order against the UNet's ip
    projections in sorted flax-name order, as the JAX package (and the
    reference's state-dict-order zip) does."""
    ckpt = [(k, _to_numpy(v)) for k, v in ip_state_dict.items() if "_ip" in k]
    paths = []

    def collect(tree, path):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, Mapping):
                if k in ("to_k_ip", "to_v_ip"):
                    paths.append(path + (k,))
                else:
                    collect(v, path + (k,))

    out = drop_paths(unet_params, ())  # a copy of the dict structure
    collect(out, ())
    if len(paths) != len(ckpt):
        raise ValueError(
            f"ip ckpt has {len(ckpt)} '_ip' tensors but the UNet exposes "
            f"{len(paths)} ip projections")
    for path, (name, arr) in zip(paths, ckpt):
        node = out
        for p in path:
            node = node[p]
        expected = tuple(node["kernel"].shape)
        kernel = arr.T
        if tuple(kernel.shape) != expected:
            raise ValueError(
                f"shape mismatch grafting {name} -> {'/'.join(path)}: "
                f"{kernel.shape} vs {expected}")
        node["kernel"] = kernel
    return out


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def state_dict_from_tree(tree: Mapping[str, Any]) -> dict:
    """A nested tree of arrays already in torch layouts → a flat state dict
    of CPU tensors (dotted names; integer arrays int64, the rest fp32)."""
    out = {}
    for path, v in _flatten(tree).items():
        v = np.asarray(v)
        out[".".join(path)] = torch.from_numpy(np.array(
            v, dtype=np.int64 if v.dtype.kind in "iu" else np.float32))
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


def _jax_shape(module: nn.Module, param: torch.Tensor) -> tuple:
    """``param``'s shape in the flax layout (a linear kernel ``(in, out)``)."""
    shape = tuple(param.shape)
    if param.ndim < 2:
        return shape
    if isinstance(module, nn.Linear):
        return shape[::-1]
    if isinstance(module, nn.Conv2d):
        return (shape[2], shape[3], shape[1], shape[0])
    if isinstance(module, nn.Conv1d):
        return (shape[2], shape[1], shape[0])
    return shape


class ParamSlot:
    """A leaf of :func:`module_tree`: one parameter of a module, standing in
    for its flax value. ``shape`` is the flax layout's; :meth:`fits` says
    whether a flax value fills it (a linear layer takes a JAX ``Conv1x1``
    kernel too, as :func:`load_jax_params` does)."""

    def __init__(self, module: nn.Module, pname: str):
        self.module, self.pname = module, pname
        self.param = getattr(module, pname)
        self.shape = _jax_shape(module, self.param)

    def fits(self, value) -> bool:
        value = np.broadcast_to(np.bool_(0), tuple(value.shape))
        if isinstance(self.module, nn.Linear) and value.ndim == 4 \
                and value.shape[:2] != (1, 1):
            return False
        try:
            got = _torch_layout(self.module, self.pname, value).shape
        except ValueError:
            return False
        return tuple(got) == tuple(self.param.shape)


def _jax_layout(module: nn.Module, pname: str,
                value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_torch_layout` (a linear kernel ``(in, out)``)."""
    if pname != "weight":
        return value
    if isinstance(module, nn.Linear):
        return value.T
    if isinstance(module, nn.Conv2d):
        return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if isinstance(module, nn.Conv1d):
        return value.transpose(2, 1, 0)  # (out, in, K) -> (K, in, out)
    return value


def flax_paths(module: nn.Module) -> dict:
    """Each torch parameter name of ``module`` → its flax path (a tuple)."""
    out = {}
    for mname, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = _flax_path(mname) + (_leaf_name(mod, pname),)
    return out


def export_jax_params(module: nn.Module,
                      tensors: Mapping[str, torch.Tensor] | None = None,
                      like: Mapping[str, Any] | None = None) -> dict:
    """``module``'s parameters as a flax tree of fp32 numpy arrays, the
    inverse of :func:`load_jax_params`; with ``tensors`` (torch names →
    tensors, e.g. a train state's trainable leaves) those tensors only, in
    place of the module's own. A linear kernel comes out ``(in, out)``;
    with ``like`` (a flax tree whose leaves have ``.shape``) each leaf takes
    ``like``'s shape, as a JAX ``Conv1x1`` kernel ``(1, 1, in, out)``."""
    shapes = {} if like is None else _flatten(like)
    left = set(tensors or ())
    tree: dict = {}
    for mname, mod in module.named_modules():
        for pname, param in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if tensors is not None:
                if name not in tensors:
                    continue
                param = tensors[name]
                left.discard(name)
            arr = _jax_layout(mod, pname,
                              param.detach().float().cpu().numpy())
            path = _flax_path(mname) + (_leaf_name(mod, pname),)
            if path in shapes:
                arr = arr.reshape(shapes[path].shape)
            _set(tree, path, np.ascontiguousarray(arr))
    if left:
        raise ValueError(f"export_jax_params: no parameter named "
                         f"{sorted(left)[:5]} in the module")
    return tree


def module_tree(module: nn.Module) -> dict:
    """``module``'s parameters as the flax tree of the JAX package (nested
    dicts by :func:`_flax_path`, leaves :class:`ParamSlot`)."""
    tree: dict = {}
    for mname, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            _set(tree, _flax_path(mname) + (_leaf_name(mod, pname),),
                 ParamSlot(mod, pname))
    return tree


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


def load_jax_params(module: nn.Module, tree: Mapping[str, Any],
                    partial: bool = False) -> nn.Module:
    """Fill ``module``'s parameters from a flax parameter tree (nested dicts
    of numpy arrays) in place. Raises on any leaf left unused, any shape
    mismatch and, unless ``partial``, any parameter left unfilled; with
    ``partial`` an unfilled parameter keeps its value, and
    :class:`ParamSlot` leaves (a :func:`module_tree` base that a checkpoint
    did not cover) are skipped."""
    src = {k: np.asarray(v) for k, v in _flatten(tree).items()
           if not isinstance(v, ParamSlot)}
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
    if (unfilled and not partial) or unused:
        raise ValueError(f"load_jax_params: unfilled torch parameters "
                         f"{unfilled[:20]}; unused flax leaves {unused[:20]} "
                         f"({len(unfilled)} unfilled, {len(unused)} unused)")
    return module
