"""The SD-1.5 AutoencoderKL and the CLIP ViT-L/14 text encoder in plain
PyTorch, channels-last, named as the port names them.

From diffusers 0.11's ``AutoencoderKL`` (``Encoder`` / ``Decoder`` with the
single-head mid-block attention, the asymmetric pad of the downsampler,
nearest ×2 upsampling) and OpenAI's CLIP text tower (causal mask,
quick-GELU, the final LayerNorm).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference import ops
from h100bench.reference.unet import Norm

VAE_SCALE = 0.18215


class VAEResnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.groups = groups
        self.norm1 = Norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = Norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        p = ops.precision_of(self)
        g = self.groups
        h = ops.conv2d(p, self.conv1,
                       F.silu(ops.group_norm(x, self.norm1, g, 1e-6)))
        h = ops.conv2d(p, self.conv2,
                       F.silu(ops.group_norm(h, self.norm2, g, 1e-6)))
        if self.conv_shortcut is not None:
            x = ops.conv2d(p, self.conv_shortcut, x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.groups = groups
        self.group_norm = Norm(ch)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x):
        p = ops.precision_of(self)
        b, h, w, c = x.shape
        y = ops.group_norm(x, self.group_norm, self.groups, 1e-6).reshape(
            b, h * w, 1, c)
        o = ops.attention(p, ops.linear(p, self.query, y),
                          ops.linear(p, self.key, y),
                          ops.linear(p, self.value, y), c ** -0.5)
        return ops.linear(p, self.proj_attn, o.reshape(b, h, w, c)) + x


class Encoder(nn.Module):
    def __init__(self, v):
        super().__init__()
        ch, g = list(v["block_out_channels"]), v["norm_num_groups"]
        self.levels, self.per = len(ch), v["layers_per_block"]
        self.groups = g
        self.conv_in = nn.Conv2d(v["in_channels"], ch[0], 3, padding=1)
        for i in range(self.levels):
            for j in range(self.per):
                self.add_module(f"down_{i}_resnet_{j}", VAEResnet(
                    ch[max(i - 1, 0)] if j == 0 else ch[i], ch[i], g))
            if i < self.levels - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch[i], ch[i], 3, stride=2))
        self.mid_resnet_1 = VAEResnet(ch[-1], ch[-1], g)
        self.mid_attn_1 = VAEAttention(ch[-1], g)
        self.mid_resnet_2 = VAEResnet(ch[-1], ch[-1], g)
        self.conv_norm_out = Norm(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * v["latent_channels"], 3,
                                  padding=1)

    def forward(self, x):
        p = ops.precision_of(self)
        h = ops.conv2d(p, self.conv_in, x)
        for i in range(self.levels):
            for j in range(self.per):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < self.levels - 1:
                # pad right and bottom by one, then a stride-2 conv
                h = ops.conv2d(p, getattr(self, f"down_{i}_downsample"),
                               F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_resnet_2(self.mid_attn_1(self.mid_resnet_1(h)))
        h = F.silu(ops.group_norm(h, self.conv_norm_out, self.groups, 1e-6))
        return ops.conv2d(p, self.conv_out, h)


class Decoder(nn.Module):
    def __init__(self, v):
        super().__init__()
        ch, g = list(v["block_out_channels"])[::-1], v["norm_num_groups"]
        self.levels, self.per = len(ch), v["layers_per_block"]
        self.groups = g
        self.conv_in = nn.Conv2d(v["latent_channels"], ch[0], 3, padding=1)
        self.mid_resnet_1 = VAEResnet(ch[0], ch[0], g)
        self.mid_attn_1 = VAEAttention(ch[0], g)
        self.mid_resnet_2 = VAEResnet(ch[0], ch[0], g)
        for i in range(self.levels):
            for j in range(self.per + 1):
                self.add_module(f"up_{i}_resnet_{j}", VAEResnet(
                    ch[max(i - 1, 0)] if j == 0 else ch[i], ch[i], g))
            if i < self.levels - 1:
                self.add_module(f"up_{i}_upsample",
                                nn.Conv2d(ch[i], ch[i], 3, padding=1))
        self.conv_norm_out = Norm(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], v["out_channels"], 3, padding=1)

    def forward(self, z):
        p = ops.precision_of(self)
        h = ops.conv2d(p, self.conv_in, z)
        h = self.mid_resnet_2(self.mid_attn_1(self.mid_resnet_1(h)))
        for i in range(self.levels):
            for j in range(self.per + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < self.levels - 1:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = ops.conv2d(p, getattr(self, f"up_{i}_upsample"), h)
        h = F.silu(ops.group_norm(h, self.conv_norm_out, self.groups, 1e-6))
        return ops.conv2d(p, self.conv_out, h)


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        v = cfg["vae"]
        c = v["latent_channels"]
        self.encoder = Encoder(v)
        self.decoder = Decoder(v)
        self.quant_conv = nn.Conv2d(2 * c, 2 * c, 1)
        self.post_quant_conv = nn.Conv2d(c, c, 1)

    def encode(self, x):
        """image ``(B, H, W, 3)`` in [-1, 1] → (mean, logvar)."""
        p = ops.precision_of(self)
        moments = ops.conv2d(p, self.quant_conv, self.encoder(x.float()))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        p = ops.precision_of(self)
        return self.decoder(ops.conv2d(p, self.post_quant_conv, z.float()))


class CLIPLayer(nn.Module):
    def __init__(self, d, ff, heads, eps):
        super().__init__()
        self.heads, self.eps = heads, eps
        self.layer_norm1 = Norm(d)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = Norm(d)
        self.mlp_fc1 = nn.Linear(d, ff)
        self.mlp_fc2 = nn.Linear(ff, d)

    def forward(self, x, mask):
        p = ops.precision_of(self)
        b, s, d = x.shape
        a = self.self_attn
        y = ops.layer_norm(x, self.layer_norm1, self.eps)

        def split(t):
            return t.reshape(b, s, self.heads, d // self.heads)

        o = ops.attention(p, split(ops.linear(p, a.q_proj, y)),
                          split(ops.linear(p, a.k_proj, y)),
                          split(ops.linear(p, a.v_proj, y)),
                          (d // self.heads) ** -0.5, bias=mask)
        x = x + ops.linear(p, a.out_proj, o.reshape(b, s, d))
        y = ops.linear(p, self.mlp_fc1, ops.layer_norm(x, self.layer_norm2,
                                                       self.eps))
        return x + ops.linear(p, self.mlp_fc2, y * torch.sigmoid(1.702 * y))


class CLIPText(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c = cfg["clip_text"]
        d = c["hidden_size"]
        self.eps = c["layer_norm_eps"]
        self.token_embedding = nn.Embedding(c["vocab_size"], d)
        self.position_embedding = nn.Embedding(c["max_position_embeddings"],
                                               d)
        self.layers = nn.ModuleList(
            CLIPLayer(d, c["intermediate_size"], c["num_attention_heads"],
                      self.eps) for _ in range(c["num_hidden_layers"]))
        self.final_layer_norm = Norm(d)

    def forward(self, ids):
        """token ids ``(B, S)`` → the last hidden state ``(B, S, d)``."""
        s = ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        x = (self.token_embedding.weight.float()[ids]
             + self.position_embedding.weight.float()[pos][None])
        causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
        mask = torch.zeros(s, s, device=ids.device).masked_fill(
            ~causal, float("-inf"))
        for layer in self.layers:
            x = layer(x, mask)
        return ops.layer_norm(x, self.final_layer_norm, self.eps)
