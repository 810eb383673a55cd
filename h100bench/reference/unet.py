"""The Follow-Your-Click UNet3D in plain PyTorch: the SD-1.5 UNet inflated
to video with AnimateDiff's Vanilla motion modules, the 9-channel
``conv_in`` and the fps and motion-score embeddings.

Written from the published description (diffusers' ``UNet2DConditionModel``
0.11, AnimateDiff's ``unet.py`` / ``motion_module.py``, Follow-Your-Click's
additions). Tensors are channels-last ``(B, F, H, W, C)``; parameters are
named as the port names them, so one state dict loads into both. Every
product goes through ``ops`` (float32, or float8 operands for the control).
Departures from the published model: none in the arithmetic; classifier-free
guidance runs the UNet on both halves of the batch rather than sharing the
stem, which gives the same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from h100bench.reference import ops


class Norm(nn.Module):
    """A norm's scale and shift (named ``weight`` and ``bias``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))


class Conv(nn.Module):
    """A per-frame 2-D conv, held under ``.conv`` as the port holds it."""

    def __init__(self, cin, cout, k, stride=1, padding=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride,
                              k // 2 if padding is None else padding)

    def forward(self, x):
        return ops.frame_conv(ops.precision_of(self), self.conv, x)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        p = ops.precision_of(self)
        return ops.linear(p, self.linear_2, F.silu(ops.linear(p, self.linear_1,
                                                              x)))


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1 = Norm(cin)
        self.conv1 = Conv(cin, cout, 3)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = Norm(cout)
        self.conv2 = Conv(cout, cout, 3)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        p = ops.precision_of(self)
        # GroupNorm over the whole clip: statistics over (F, H, W, C / g)
        h = self.conv1(F.silu(ops.group_norm(x, self.norm1, self.groups,
                                             self.eps)))
        h = h + ops.linear(p, self.time_emb_proj, F.silu(temb))[
            :, None, None, None]
        h = self.conv2(F.silu(ops.group_norm(h, self.norm2, self.groups,
                                             self.eps)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, heads, kv_dim=None, out_bias=True):
        super().__init__()
        kv_dim = kv_dim or dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv_dim, dim, bias=False)
        self.to_v = nn.Linear(kv_dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=out_bias)

    def forward(self, x, context=None):
        p = ops.precision_of(self)
        context = x if context is None else context
        n, s, c = x.shape
        d = c // self.heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, d)

        o = ops.attention(p, split(ops.linear(p, self.to_q, x)),
                          split(ops.linear(p, self.to_k, context)),
                          split(ops.linear(p, self.to_v, context)),
                          d ** -0.5)
        return ops.linear(p, self.to_out, o.reshape(n, s, c))


class GEGLU(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * mult * dim)
        self.out = nn.Linear(mult * dim, dim)

    def forward(self, x):
        p = ops.precision_of(self)
        h, gate = ops.linear(p, self.proj, x).chunk(2, dim=-1)
        return ops.linear(p, self.out, h * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, cross_dim):
        super().__init__()
        self.norm1 = Norm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = Norm(dim)
        self.attn2 = Attention(dim, heads, cross_dim)
        self.norm3 = Norm(dim)
        self.ff = GEGLU(dim)

    def forward(self, h, context):
        h = self.attn1(ops.layer_norm(h, self.norm1)) + h
        h = self.attn2(ops.layer_norm(h, self.norm2), context) + h
        return self.ff(ops.layer_norm(h, self.norm3)) + h


class SpatialTransformer(nn.Module):
    """GroupNorm per frame → proj_in → block → proj_out → + input."""

    def __init__(self, ch, heads, cross_dim, groups):
        super().__init__()
        self.groups = groups
        self.norm = Norm(ch)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, cross_dim)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context):
        p = ops.precision_of(self)
        b, f, hh, ww, c = x.shape
        res = x.reshape(b * f, hh, ww, c)
        h = ops.group_norm(res, self.norm, self.groups, 1e-6).reshape(
            b * f, hh * ww, c)
        h = ops.linear(p, self.proj_in, h)
        ctx = context.repeat_interleave(f, dim=0)
        for blk in self.transformer_blocks:
            h = blk(h, ctx)
        h = ops.linear(p, self.proj_out, h).reshape(b * f, hh, ww, c)
        return (h + res).reshape(b, f, hh, ww, c)


class TemporalAttention(Attention):
    """Self-attention over the frames, the positional table added to its
    (normed) input."""

    def forward(self, x, context=None):
        pe = ops.positional_table(x.shape[1], x.shape[2], x.device)
        return super().forward(x + pe[None])


class TemporalBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norms = nn.ModuleList([Norm(dim), Norm(dim)])
        self.attention_blocks = nn.ModuleList(
            [TemporalAttention(dim, heads), TemporalAttention(dim, heads)])
        self.ff_norm = Norm(dim)
        self.ff = GEGLU(dim)

    def forward(self, h):
        for norm, attn in zip(self.norms, self.attention_blocks):
            h = attn(ops.layer_norm(h, norm)) + h
        return self.ff(ops.layer_norm(h, self.ff_norm)) + h


class MotionModule(nn.Module):
    """GroupNorm per frame → proj_in → temporal block over ``(B·H·W, F, C)``
    → proj_out → + input."""

    def __init__(self, ch, heads):
        super().__init__()
        self.norm = Norm(ch)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([TemporalBlock(ch, heads)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x):
        p = ops.precision_of(self)
        b, f, hh, ww, c = x.shape
        res = x.reshape(b * f, hh, ww, c)
        h = ops.group_norm(res, self.norm, 32, 1e-6).reshape(b, f, hh * ww, c)
        h = ops.linear(p, self.proj_in, h)
        h = h.permute(0, 2, 1, 3).reshape(b * hh * ww, f, c)
        for blk in self.transformer_blocks:
            h = blk(h)
        h = ops.linear(p, self.proj_out, h)
        h = h.reshape(b, hh * ww, f, c).permute(0, 2, 1, 3)
        return h.reshape(b, f, hh, ww, c) + x


class Down(nn.Module):
    def __init__(self, cfg, cin, cout, down, motion, cross):
        super().__init__()
        u, n = cfg["unet"], cfg["unet"]["layers_per_block"]
        temb = 4 * u["block_out_channels"][0]
        heads = u["attention_head_dim"]
        self.resnets = nn.ModuleList(
            Resnet(cin if i == 0 else cout, cout, temb,
                   u["norm_num_groups"], u["norm_eps"]) for i in range(n))
        self.attentions = nn.ModuleList(
            SpatialTransformer(cout, heads, u["cross_attention_dim"],
                               u["norm_num_groups"])
            for _ in range(n)) if cross else None
        self.motion_modules = nn.ModuleList(
            MotionModule(cout, u["motion_module_kwargs"]["num_attention_heads"])
            for _ in range(n)) if motion else None
        self.downsamplers = nn.ModuleList(
            [Conv(cout, cout, 3, stride=2, padding=1)]) if down else None

    def forward(self, h, temb, context):
        skips = []
        for i, resnet in enumerate(self.resnets):
            h = resnet(h, temb)
            if self.attentions is not None:
                h = self.attentions[i](h, context)
            if self.motion_modules is not None:
                h = self.motion_modules[i](h)
            skips.append(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
            skips.append(h)
        return h, skips


class Mid(nn.Module):
    def __init__(self, cfg, ch):
        super().__init__()
        u = cfg["unet"]
        temb = 4 * u["block_out_channels"][0]
        self.resnets = nn.ModuleList(
            Resnet(ch, ch, temb, u["norm_num_groups"], u["norm_eps"])
            for _ in range(2))
        self.attentions = nn.ModuleList([SpatialTransformer(
            ch, u["attention_head_dim"], u["cross_attention_dim"],
            u["norm_num_groups"])])

    def forward(self, h, temb, context):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, context)
        return self.resnets[1](h, temb)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv, per frame."""

    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return ops.frame_conv(ops.precision_of(self), self.conv, x)


class Up(nn.Module):
    def __init__(self, cfg, skip_chs, prev, cout, up, motion, cross):
        super().__init__()
        u = cfg["unet"]
        temb = 4 * u["block_out_channels"][0]
        heads = u["attention_head_dim"]
        n = len(skip_chs)
        self.resnets = nn.ModuleList(
            Resnet((prev if i == 0 else cout) + skip_chs[i], cout, temb,
                   u["norm_num_groups"], u["norm_eps"]) for i in range(n))
        self.attentions = nn.ModuleList(
            SpatialTransformer(cout, heads, u["cross_attention_dim"],
                               u["norm_num_groups"])
            for _ in range(n)) if cross else None
        self.motion_modules = nn.ModuleList(
            MotionModule(cout, u["motion_module_kwargs"]["num_attention_heads"])
            for _ in range(n)) if motion else None
        self.upsamplers = nn.ModuleList([Upsample(cout)]) if up else None

    def forward(self, h, skips, temb, context):
        skips = list(skips)  # a checkpoint's recompute pops them again
        for i, resnet in enumerate(self.resnets):
            h = resnet(torch.cat([h, skips.pop()], dim=-1), temb)
            if self.attentions is not None:
                h = self.attentions[i](h, context)
            if self.motion_modules is not None:
                h = self.motion_modules[i](h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class UNet3D(nn.Module):
    """``forward(sample, t, context, fps, motion_score)``: ``sample`` is
    the noisy latent with the click mask and the first-frame latent on the
    channel axis, every argument at the same batch.
    ``checkpoint_blocks``: each block a checkpoint region under autograd
    (memory only; the numbers are the same)."""

    def __init__(self, cfg: dict, checkpoint_blocks: bool = False):
        super().__init__()
        u = cfg["unet"]
        boc = list(u["block_out_channels"])
        c0, temb = boc[0], 4 * boc[0]
        n = u["layers_per_block"]
        levels = [2 ** i in u["motion_module_resolutions"]
                  for i in range(len(boc))]
        self.checkpoint_blocks = checkpoint_blocks
        self.groups, self.eps = u["norm_num_groups"], u["norm_eps"]
        self.c0 = c0
        self.time_embedding = TimestepEmbedding(c0, temb)
        self.fps_embedding = TimestepEmbedding(c0, temb)
        self.motion_embedding = TimestepEmbedding(c0, temb)
        self.conv_in = Conv(2 * u["in_channels"] + 1, c0, 3)
        skips = [c0]
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(u["down_block_types"]):
            last = i == len(boc) - 1
            self.down_blocks.append(Down(cfg, boc[max(i - 1, 0)], boc[i],
                                         not last, levels[i],
                                         kind.startswith("CrossAttn")))
            skips += [boc[i]] * (n + (0 if last else 1))
        self.mid_block = Mid(cfg, boc[-1])
        rev = boc[::-1]
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(u["up_block_types"]):
            mine, skips = skips[-(n + 1):], skips[:-(n + 1)]
            self.up_blocks.append(Up(
                cfg, mine[::-1], rev[max(i - 1, 0)], rev[i],
                i != len(boc) - 1, levels[len(boc) - 1 - i],
                kind.startswith("CrossAttn")))
        self.conv_norm_out = Norm(c0)
        self.conv_out = Conv(c0, u["out_channels"], 3)

    def _run(self, block, *args):
        if self.checkpoint_blocks and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample, t, context, fps, motion_score):
        c0 = self.c0
        emb = self.time_embedding(ops.timestep_embedding(t, c0))
        emb = emb + self.fps_embedding(ops.timestep_embedding(fps, c0))
        emb = emb + self.motion_embedding(ops.timestep_embedding(
            motion_score, c0))
        context = context.float()
        h = self.conv_in(sample.float())
        skips = [h]
        for block in self.down_blocks:
            h, res = self._run(block, h, emb, context)
            skips += res
        h = self._run(self.mid_block, h, emb, context)
        for block in self.up_blocks:
            n = len(block.resnets)
            mine, skips = skips[-n:], skips[:-n]
            h = self._run(block, h, mine, emb, context)
        h = F.silu(ops.group_norm(h, self.conv_norm_out, self.groups,
                                  self.eps))
        return self.conv_out(h)
