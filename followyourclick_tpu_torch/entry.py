"""One CFG UNet3D step of the flagship configuration, as a callable.

The port's counterpart of ``__graft_entry__.entry``: the full SD-1.5 widths
with the motion modules and the 9-channel mask-conditioned ``conv_in``
(``UNet3DConfig()``), one clip of 8 frames at 32² latents (256²), the
context at the CFG-doubled batch (prefix sharing: the stem runs once and the
UNet duplicates at the first cross-attention). The weights are PyTorch's
default init; the inputs are zeros.

    from followyourclick_tpu_torch.entry import entry
    fn, args = entry()
    out = fn(*args)            # (2, 8, 32, 32, 4)
"""

from __future__ import annotations

import torch

from followyourclick_tpu_torch.config import UNet3DConfig
from followyourclick_tpu_torch.models.unet3d import (
    UNet3DConditionModel,
    UNetConditioning,
)


def entry(device: torch.device | str = "cuda"):
    """``(fn, example_args)``: ``fn(sample, timesteps, cond)`` is one
    forward of the UNet on ``device`` (the card unless the caller asks for
    the CPU), in bf16 on the card and fp32 elsewhere."""
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = UNet3DConfig()
    with torch.device(device):
        unet = UNet3DConditionModel(cfg)
    unet = unet.to(dtype).eval()
    b, f, h, w = 1, 8, 32, 32
    sample = torch.zeros(b, f, h, w, UNet3DConditionModel.conv_in_channels(
        cfg), device=device, dtype=dtype)
    timesteps = torch.zeros(b, dtype=torch.int64, device=device)
    cond = UNetConditioning(
        context=torch.zeros(2 * b, 77, cfg.cross_attention_dim,
                            device=device, dtype=dtype),
        fps=torch.full((b,), 8.0, device=device),
        motion_score=torch.full((b,), 20.0, device=device))

    @torch.inference_mode()
    def fn(sample, timesteps, cond):
        return unet(sample, timesteps, cond)

    return fn, (sample, timesteps, cond)
