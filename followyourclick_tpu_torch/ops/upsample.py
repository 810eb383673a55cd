"""Nearest-2×-upsample → 3×3 conv as four 2×2 phase convolutions.

Port of ``followyourclick_tpu/ops/upsample.py`` (plain ops there too; no
kernel). With nearest upsampling the 3×3 taps read duplicated pixels, so for
each output phase (a, b) the taps collapse onto a 2×2 window of the low-res
input with pre-summed weights (done in fp32):

  a=0: rows (−1, 0) with W[0] and W[1]+W[2];  a=1: rows (0, +1) with
  W[0]+W[1] and W[2]; columns likewise.

16 MACs per 4 output pixels instead of 36, and the 4×-sized upsampled
intermediate never exists.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv3x3_nearest_up2(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """conv3x3(nearest_upsample_2x(x)) without materialising the upsample.

    x: (B, H, W, Cin); weight: (Co, Cin, 3, 3) OIHW; bias: (Co,) or None.
    Returns (B, 2H, 2W, Co).
    """
    b, h, w, _ = x.shape
    co = weight.shape[0]
    wf = weight.float()
    xc = _nchw(x)

    def taps(k, axis, phase):
        first, mid, last = k.unbind(axis)
        if phase == 0:
            return torch.stack([first, mid + last], dim=axis)
        return torch.stack([first + mid, last], dim=axis)

    phases = []
    for a in (0, 1):
        ka = taps(wf, 2, a)                       # (Co, Cin, 2, 3)
        for bb in (0, 1):
            kab = taps(ka, 3, bb)                 # (Co, Cin, 2, 2)
            pad_r = (1, 0) if a == 0 else (0, 1)
            pad_c = (1, 0) if bb == 0 else (0, 1)
            xp = F.pad(xc, pad_c + pad_r)
            phases.append(_nhwc(F.conv2d(xp, kab.to(x.dtype))))
    out = torch.stack(phases, dim=3).reshape(b, h, w, 2, 2, co)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, co)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def reference_up2_conv(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The materialising formulation (tests / readability)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = _nhwc(F.conv2d(_nchw(up), weight.to(x.dtype), padding=1))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
