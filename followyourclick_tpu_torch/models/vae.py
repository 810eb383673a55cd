"""AutoencoderKL, the SD-1.5 image VAE, on channels-last ``(B, H, W, C)``.

Port of ``followyourclick_tpu/models/vae.py``: encoder (the first-frame
latent), decoder (with the exact phase-decomposed upsample convs of
``ops/upsample.py``), the single-head mid-block attention whose q and k are
each scaled by ``c^-1/4``, and the quant / post-quant 1×1 convs. Callers
apply the 0.18215 latent scale.

Tensor parallel (``parallel/sharding.shard_params`` sets ``tp``): the
mid-block attention's one head is split on its channels. A rank's logits
are a partial sum over its channels, so they are all-reduced (fp32) before
the softmax; ``p · v_local`` then gives the rank's channels of the output
(``p``'s gradient, a sum over the ranks' channels, all-reduced in the
backward), and ``proj_attn`` is row-parallel. Everything else stays
replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.config import VAEConfig
from followyourclick_tpu_torch.models.layers import GroupNorm
from followyourclick_tpu_torch.models.resnet import conv_nhwc
from followyourclick_tpu_torch.ops.upsample import conv3x3_nearest_up2
from followyourclick_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
    row_linear,
)


class VAEResnetBlock(nn.Module):
    """norm → SiLU → conv ×2, 1×1 shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels, groups, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv1, F.silu(self.norm1(x)))
        h = conv_nhwc(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head spatial self-attention (diffusers AttentionBlock)."""

    tp = None  # the mesh, once shard_params keeps this rank's channels

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, eps=1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, 1, h * w, c)
        s = c ** -0.25
        if self.tp is not None:
            return self._sharded(y.reshape(b, h * w, c), s).reshape(
                b, h, w, c) + x
        y = F.scaled_dot_product_attention(self.query(y) * s,
                                           self.key(y) * s, self.value(y),
                                           scale=1.0)
        return self.proj_attn(y).reshape(b, h, w, c) + x

    def _sharded(self, y: torch.Tensor, s: float) -> torch.Tensor:
        """The attention on this rank's channels (JAX ``vae.py:60-77``:
        fp32 logits, the weights cast to the activations' dtype)."""
        mesh = self.tp
        y_in = copy_to_model(y, mesh)
        q, k, v = (self.query(y_in) * s, self.key(y_in) * s,
                   self.value(y_in))
        logits = reduce_from_model(
            torch.einsum("bqc,bkc->bqk", q.float(), k.float()), mesh)
        # p is whole on every rank, but each rank reads it against its own
        # channels of v: its gradient is the ranks' sum (f)
        p = copy_to_model(torch.softmax(logits, dim=-1).to(y.dtype), mesh)
        return row_linear(torch.einsum("bqk,bkc->bqc", p, v),
                          self.proj_attn, mesh)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.n_levels = len(cfg.down_block_types)
        self.layers_per_block = cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        for i in range(self.n_levels):
            for j in range(cfg.layers_per_block):
                in_ch = ch[max(i - 1, 0)] if j == 0 else ch[i]
                self.add_module(f"down_{i}_resnet_{j}",
                                VAEResnetBlock(in_ch, ch[i], g))
            if i < self.n_levels - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch[i], ch[i], 3, stride=2))
        self.mid_resnet_1 = VAEResnetBlock(ch[-1], ch[-1], g)
        self.mid_attn_1 = VAEAttentionBlock(ch[-1], g)
        self.mid_resnet_2 = VAEResnetBlock(ch[-1], ch[-1], g)
        self.conv_norm_out = GroupNorm(ch[-1], g, eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv_in, x)
        for i in range(self.n_levels):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < self.n_levels - 1:
                # diffusers Downsample2D(padding=0): pad right/bottom by one
                h = conv_nhwc(getattr(self, f"down_{i}_downsample"),
                              F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_resnet_2(self.mid_attn_1(self.mid_resnet_1(h)))
        return conv_nhwc(self.conv_out, F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.n_levels = len(cfg.up_block_types)
        self.layers_per_block = cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_resnet_1 = VAEResnetBlock(ch[0], ch[0], g)
        self.mid_attn_1 = VAEAttentionBlock(ch[0], g)
        self.mid_resnet_2 = VAEResnetBlock(ch[0], ch[0], g)
        for i in range(self.n_levels):
            for j in range(cfg.layers_per_block + 1):
                in_ch = ch[max(i - 1, 0)] if j == 0 else ch[i]
                self.add_module(f"up_{i}_resnet_{j}",
                                VAEResnetBlock(in_ch, ch[i], g))
            if i < self.n_levels - 1:
                self.add_module(f"up_{i}_upsample",
                                nn.Conv2d(ch[i], ch[i], 3, padding=1))
        self.conv_norm_out = GroupNorm(ch[-1], g, eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv_in, z)
        h = self.mid_resnet_2(self.mid_attn_1(self.mid_resnet_1(h)))
        for i in range(self.n_levels):
            for j in range(self.layers_per_block + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < self.n_levels - 1:
                up = getattr(self, f"up_{i}_upsample")
                h = conv3x3_nearest_up2(h, up.weight.to(h.dtype),
                                        up.bias.to(h.dtype))
        return conv_nhwc(self.conv_out, F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        c = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * c, 2 * c, 1)
        self.post_quant_conv = nn.Conv2d(c, c, 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) → (mean, logvar), each (B, H/8, W/8, 4)."""
        moments = conv_nhwc(self.quant_conv, self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(conv_nhwc(self.post_quant_conv, z))
