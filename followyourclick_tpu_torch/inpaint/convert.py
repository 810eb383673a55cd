"""Big-LaMa checkpoints for the port.

The port's generator carries the reference's torch names
(``model.{index}...``), so a released ``big-lama/models/best.ckpt`` — a
PyTorch Lightning checkpoint whose ``state_dict`` holds the generator under
``generator.model.*`` beside the discriminator and the losses' networks — is
the port's state dict once the ``generator.`` prefix is cut:
:func:`load_lama_checkpoint` reads it with ``torch.load(weights_only=True)``
(no pickled object is run: a file whose metadata holds classes other than
containers, strings and numbers is refused by torch, not unpickled) and
keeps the ``model.*`` keys, with or without the prefix.

:func:`lama_state_from_jax` is the inverse of the JAX package's
``inpaint/convert.convert_lama_state_dict``: the JAX generator's
``{"params", "batch_stats"}`` tree → the port's state dict, so the two
packages run on the same weights. Layouts: a flax Conv kernel ``(kh, kw,
in, out)`` → ``(out, in, kh, kw)``; the upsamples' ``ConvTranspose``
(``transpose_kernel=True``) kernel ``(kh, kw, out, in)`` → torch's ``(in,
out, kh, kw)``, the same transpose: flax flips the kernel in the call, as
torch's transposed convolution does, so the stored values are not flipped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from followyourclick_tpu_torch.inpaint.lama import LamaConfig
from followyourclick_tpu_torch.utils.convert import state_dict_from_tree


def generator_state(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The generator's entries of a checkpoint's state dict: ``model.*``
    keys, ``generator.model.*`` ones with the prefix cut; everything else
    (the discriminator, the losses' networks) is dropped."""
    out = {}
    for k, v in state_dict.items():
        k = k.removeprefix("generator.")
        if k.startswith("model."):
            out[k] = v
    return out


def load_lama_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A big-LaMa checkpoint (a Lightning ``best.ckpt`` with a
    ``state_dict``, or a bare state dict) → the generator's state dict, on
    the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return generator_state(ckpt.get("state_dict", ckpt))


def _conv(p):
    out = {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _bn(p, s):
    p, s = p["BatchNorm_0"], s["BatchNorm_0"]
    return {"weight": p["scale"], "bias": p["bias"],
            "running_mean": s["mean"], "running_var": s["var"],
            "num_batches_tracked": np.zeros((), np.int64)}


def _spectral(p, s):
    out = {"conv1": {"0": _conv(p["conv1"]), "1": _bn(p["bn1"], s["bn1"])},
           "fu": {"conv_layer": _conv(p["fu"]["conv"]),
                  "bn": _bn(p["fu"]["bn"], s["fu"]["bn"])},
           "conv2": _conv(p["conv2"])}
    if "lfu" in p:
        out["lfu"] = {"conv_layer": _conv(p["lfu"]["conv"]),
                      "bn": _bn(p["lfu"]["bn"], s["lfu"]["bn"])}
    return out


def _ffc_bn_act(p, s):
    ffc = {name: _conv(p["ffc"][name])
           for name in ("convl2l", "convl2g", "convg2l") if name in p["ffc"]}
    if "convg2g" in p["ffc"]:
        ffc["convg2g"] = _spectral(p["ffc"]["convg2g"],
                                   s["ffc"]["convg2g"])
    out = {"ffc": ffc}
    for bn in ("bn_l", "bn_g"):
        if bn in p:
            out[bn] = _bn(p[bn], s[bn])
    return out


def lama_state_from_jax(variables: Mapping[str, Any],
                        config: LamaConfig = LamaConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``FFCResNetGenerator``'s variables → the port's state dict
    (fp32 CPU tensors, ``num_batches_tracked`` 0)."""
    p, s = variables["params"], variables["batch_stats"]
    d, n = config.n_downsampling, config.n_blocks
    model = {"1": _ffc_bn_act(p["stem"], s["stem"])}
    for i in range(d):
        model[str(2 + i)] = _ffc_bn_act(p[f"down{i}"], s[f"down{i}"])
    for i in range(n):
        b = f"block{i}"
        model[str(2 + d + i)] = {
            c: _ffc_bn_act(p[b][c], s[b][c]) for c in ("conv1", "conv2")}
    up = 2 + d + n + 1  # after ConcatTupleLayer
    for i in range(d):
        model[str(up + 3 * i)] = _conv(p[f"up{i}"])
        model[str(up + 3 * i + 1)] = _bn(p[f"up_bn{i}"], s[f"up_bn{i}"])
    model[str(up + 3 * d + 1)] = _conv(p["head"])
    return state_dict_from_tree({"model": model})
