"""Seeded random weights for a module, for runs without a checkpoint.

Every parameter (and each buffer named in ``buffers``) is drawn from one
``torch.Generator`` on the generator's device, in the module's parameter
order, so a seed gives the same weights on every device a generator of
that type runs on. Kernels of linear layers and convs: N(0, 1/fan_in) (a
transposed conv's fan-in is its input channels); embeddings and the named
buffers: N(0, 1), but for BN running statistics (``running_mean``:
N(0, 0.02²); ``running_var``: 1 + N(0, 0.05²)); norm scales (a 1-D
``weight``): 1 + N(0, 0.05²); biases and every other parameter (positions,
tables): N(0, 0.02²).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator,
                 buffers: Sequence[str] = ()) -> nn.Module:
    for _, mod in module.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + [
            (n, b) for n, b in mod.named_buffers(recurse=False)
            if n in buffers]
        for name, p in tensors:
            z = torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            if name == "running_mean":
                z = 0.02 * z
            elif name == "running_var" or (name == "weight" and p.ndim == 1):
                z = 1.0 + 0.05 * z
            elif name in buffers or (name == "weight"
                                     and isinstance(mod, nn.Embedding)):
                pass
            elif name == "weight" and isinstance(mod, nn.ConvTranspose2d):
                z = z / math.sqrt(p.shape[0])
            elif name == "weight":
                z = z / math.sqrt(math.prod(p.shape[1:]))
            else:
                z = 0.02 * z
            p.copy_(z.to(p.device, p.dtype))
    return module
