"""Shared building blocks: sinusoidal embeddings, TimestepEmbedding,
GroupNorm and LayerNorm over the trailing channel axis, and the NCHW
BatchNorm2d with flax's statistics update (LaMa, RAFT).

Port of ``followyourclick_tpu/models/layers.py``. Activations keep the JAX
package's channels-last layout ``(N, ..., C)``, but for BatchNorm2d.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0
                                  ) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` (max period 10000), always in
    fp32."""
    assert timesteps.ndim == 1
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def temporal_positional_encoding(length: int, d_model: int,
                                 device=None) -> torch.Tensor:
    """Interleaved sin/cos table ``(1, length, d_model)``: pe[:, 0::2] = sin,
    pe[:, 1::2] = cos (reference motion_module.py:286-304)."""
    position = torch.arange(length, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model))
    angles = position * div_term
    pe = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    return pe.reshape(length, -1)[:, :d_model][None]


class TimestepEmbedding(nn.Module):
    """linear_1 → SiLU → linear_2. ``zero_init_output`` zeroes linear_2 so a
    freshly built embedding is a no-op (reference unet.py:134-146)."""

    def __init__(self, in_features: int, time_embed_dim: int,
                 zero_init_output: bool = False):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)
        if zero_init_output:
            nn.init.zeros_(self.linear_2.weight)
            nn.init.zeros_(self.linear_2.bias)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class GroupNorm(nn.Module):
    """GroupNorm over the trailing channel axis of ``(B, ..., C)``.

    Statistics are fp32 over every axis but the batch and the group, shifted
    by a pilot value (the group's first element at position 0) so that
    E[x²]−E[x]² does not cancel when |mean| ≫ std. On the 5-D clip
    ``(B, F, H, W, C)`` this takes statistics over ``(F, H, W, C/g)``, not
    per frame, as the reference's plain GroupNorm does; ``F.group_norm`` on
    frames folded into the batch would be per frame. ``act="silu"`` applies
    the SiLU that follows the norm at the call sites that fold it.
    """

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act: str | None = None):
        super().__init__()
        assert num_channels % num_groups == 0, (num_channels, num_groups)
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        cg = c // g
        xf = x.float()
        red = tuple(range(1, x.ndim - 1))
        n = cg
        for a in red:
            n *= x.shape[a]
        first = xf[(slice(None),) + (0,) * (x.ndim - 2)]          # (B, C)
        pilot_g = first.reshape(b, g, cg)[:, :, :1]                # (B, G, 1)
        pilot_c = pilot_g.expand(b, g, cg).reshape(b, c)
        bshape = (b,) + (1,) * (x.ndim - 2) + (c,)
        shifted = xf - pilot_c.reshape(bshape)
        s1 = shifted.sum(dim=red).reshape(b, g, cg).sum(-1, keepdim=True)
        s2 = (shifted * shifted).sum(dim=red).reshape(b, g, cg).sum(
            -1, keepdim=True)
        mean_c = s1 / n
        var = torch.clamp(s2 / n - mean_c * mean_c, min=0.0)
        mean = mean_c + pilot_g
        inv = torch.rsqrt(var + self.eps)
        scale = self.weight.float().reshape(1, g, cg)
        a = (inv * scale).reshape(b, c)
        bb = (self.bias.float().reshape(1, g, cg) - mean * inv * scale
              ).reshape(b, c)
        out = xf * a.reshape(bshape) + bb.reshape(bshape)
        if self.act == "silu":
            out = F.silu(out)
        return out.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the trailing axis with fp32 statistics; the output is
    in the input's dtype (flax ``nn.LayerNorm`` semantics)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


# the buffers of a BatchNorm2d that seeded weights draw and checkpoints hold
BN_STATS = ("running_mean", "running_var")


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training mode normalises by the batch's
    statistics and updates the running ones as ``flax.linen.BatchNorm``
    does: ``r ← 0.9·r + 0.1·batch`` with the biased variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.to(self.running_mean),
                                               alpha=m)
            self.running_var.mul_(1 - m).add_(var.to(self.running_var),
                                              alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)
