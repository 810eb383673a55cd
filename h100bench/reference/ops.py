"""The reference's arithmetic: every product in float32 with TF32 off, or,
for the control, with each operand rounded to float8 (e4m3) first.

``Precision("fp32")`` is the plain reference. ``Precision("fp8")`` is the
control that the check must refuse: the same modules with every operand of
every product (weights and activations of the linears, the convolutions
and both products of attention) rounded to ``float8_e4m3fn`` under a
per-tensor scale, and every state the sampler hands from step to step
(context, latents) rounded the same way. The products themselves still
accumulate in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn
ATTENTION_CHUNK_BYTES = 1 << 30  # fp32 scores held at once


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in float32, rounded through float8 under the control
        (with the gradient passed straight through the rounding)."""
        x = x.float()
        if self.kind == "fp32":
            return x
        with torch.no_grad():
            scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
            r = (x * scale).to(torch.float8_e4m3fn).float() / scale
        if torch.is_grad_enabled() and x.requires_grad:
            return x + (r - x).detach()
        return r


FP32 = Precision("fp32")


def set_precision(module: torch.nn.Module, prec: Precision) -> None:
    """Every submodule of ``module`` computes under ``prec``."""
    for m in module.modules():
        m.prec = prec


def precision_of(module: torch.nn.Module) -> Precision:
    return getattr(module, "prec", FP32)


_FLAGS = ((torch.backends.cuda.matmul, "allow_tf32"),
          (torch.backends.cudnn, "allow_tf32"),
          (torch.backends.cuda.matmul,
           "allow_bf16_reduced_precision_reduction"),
          (torch.backends.cuda.matmul,
           "allow_fp16_reduced_precision_reduction"))


@contextlib.contextmanager
def ieee_fp32():
    """Within the block IEEE float32 products: TF32 off in cuBLAS and
    cuDNN, no reduced-precision reductions; the process's flags back
    afterwards, so that the program always runs at its own."""
    saved = [getattr(owner, name) for owner, name in _FLAGS]
    for owner, name in _FLAGS:
        setattr(owner, name, False)
    try:
        yield
    finally:
        for (owner, name), value in zip(_FLAGS, saved):
            setattr(owner, name, value)


def linear(p: Precision, layer: torch.nn.Linear, x: torch.Tensor
           ) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.float()
    return F.linear(p.q(x), p.q(layer.weight), bias)


def conv2d(p: Precision, layer: torch.nn.Conv2d, x: torch.Tensor,
           padding=None) -> torch.Tensor:
    """``layer`` on a channels-last ``(N, H, W, C)`` tensor."""
    pad = layer.padding if padding is None else padding
    y = F.conv2d(p.q(x).permute(0, 3, 1, 2), p.q(layer.weight),
                 layer.bias.float(), layer.stride, pad)
    return y.permute(0, 2, 3, 1)


def frame_conv(p: Precision, layer: torch.nn.Conv2d, x: torch.Tensor
               ) -> torch.Tensor:
    """A 2-D conv on every frame of a ``(B, F, H, W, C)`` clip."""
    b, f = x.shape[:2]
    y = conv2d(p, layer, x.reshape(b * f, *x.shape[2:]))
    return y.reshape(b, f, *y.shape[1:])


def group_norm(x: torch.Tensor, norm: torch.nn.Module, groups: int,
               eps: float) -> torch.Tensor:
    """GroupNorm of a channels-last tensor: statistics over every axis but
    the first and the group, in float32."""
    xc = x.float().movedim(-1, 1)
    y = F.group_norm(xc, groups, norm.weight.float(), norm.bias.float(), eps)
    return y.movedim(1, -1)


def layer_norm(x: torch.Tensor, norm: torch.nn.Module, eps: float = 1e-5
               ) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), norm.weight.float(),
                        norm.bias.float(), eps)


def attention(p: Precision, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, scale: float,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q kᵀ · scale + bias) v over ``(N, S, H, D)`` tensors, in
    blocks of rows of (N · H) so that the scores fit."""
    n, sq, h, d = q.shape
    sk = k.shape[1]
    qh = q.permute(0, 2, 1, 3).reshape(n * h, sq, d)
    kh = k.permute(0, 2, 1, 3).reshape(n * h, sk, d)
    vh = v.permute(0, 2, 1, 3).reshape(n * h, sk, v.shape[-1])
    rows = max(1, ATTENTION_CHUNK_BYTES // (4 * sq * sk))
    out = []
    for s in range(0, n * h, rows):
        logits = torch.bmm(p.q(qh[s:s + rows]),
                           p.q(kh[s:s + rows]).transpose(1, 2)) * scale
        if bias is not None:
            logits = logits + bias
        probs = torch.softmax(logits, dim=-1)
        out.append(torch.bmm(p.q(probs), p.q(vh[s:s + rows])))
    o = torch.cat(out)
    return o.reshape(n, h, sq, -1).permute(0, 2, 1, 3)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with ``flip_sin_to_cos`` and
    no shift: [cos, sin] of t · 10000^(−i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def positional_table(frames: int, dim: int, device) -> torch.Tensor:
    """AnimateDiff's temporal positional encoding: sin on the even
    channels, cos on the odd ones, ``(frames, dim)``."""
    pos = torch.arange(frames, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(frames, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
