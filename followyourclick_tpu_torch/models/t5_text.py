"""T5 v1.1 encoder: the optional second text tower.

Port of ``followyourclick_tpu/models/t5_text.py``: relative-position buckets
and their bias (built once, in layer 0, and shared by every layer), RMSNorm
in fp32, unscaled attention (``scale = 1``) with the padding mask as an
additive bias, the gated-GELU (tanh) feed-forward and the final norm. The
UNet projects the last hidden states into its cross-attention width
(``text_encoder_proj_model_t5``). Attention with a bias takes the plain
route, as in the JAX package, so the encoder runs on stock PyTorch ops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from followyourclick_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class T5Config:
    """The JAX package's ``T5Config`` with the same fields and defaults:
    T5-v1.1-XXL (24 layers, d_model 4096, 64 heads of 64, d_ff 10240)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated_act: bool = True


class RMSNorm(nn.Module):
    """x / sqrt(mean(x²) + eps) · weight, in fp32; output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)
                * self.weight.float()).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bidirectional buckets: half the buckets a side, exact up to a
    quarter of them, logarithmic up to ``max_distance``."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int64)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, heads, S, S) fp32 bias of key position minus query position."""
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        table = self.relative_attention_bias.weight.float()
        return table[buckets].permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, _ = x.shape

        def split(t):
            return t.reshape(b, s, cfg.num_heads, cfg.d_kv)

        if position_bias is None and hasattr(self, "relative_attention_bias"):
            position_bias = self.position_bias(s, x.device)
        bias = position_bias
        if mask is not None:
            bias = mask if bias is None else bias + mask
        out = dot_product_attention(split(self.q(x)), split(self.k(x)),
                                    split(self.v(x)), bias=bias, scale=1.0)
        return self.o(out.reshape(b, s, -1)), position_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.gated = cfg.gated_act
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attention = T5Attention(cfg, has_relative_bias)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        if cfg.gated_act:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
        attn, position_bias = self.attention(self.ln1(x), mask,
                                             position_bias)
        x = x + attn
        normed = self.ln2(x)
        if self.gated:
            h = F.gelu(self.wi_0(normed), approximate="tanh") \
                * self.wi_1(normed)
        else:
            h = F.relu(self.wi(normed))
        return x + self.wo(h), position_bias


class T5EncoderModel(nn.Module):
    """Token ids (B, S) and an optional padding mask (B, S) → the last
    hidden states (B, S, d_model)."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.block = nn.ModuleList(T5Block(cfg, has_relative_bias=i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.shared(input_ids)
        mask = None
        if attention_mask is not None:
            # a padded key gets -1e9 (fp32) in every query's logits
            mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               -1e9).to(torch.float32)
        position_bias = None
        for block in self.block:
            x, position_bias = block(x, mask, position_bias)
        return self.final_layer_norm(x)


def convert_t5_state_dict(state_dict) -> dict:
    """An HF ``T5EncoderModel`` state dict → the flax tree of the JAX
    package's ``T5EncoderModel`` (``block_{i}/{attention,ln1,ln2,wi_0,wi_1,
    wo}``, ``shared/embedding``, ``final_layer_norm/scale``), which
    ``utils/convert.load_jax_params`` puts into this module."""
    import re

    from followyourclick_tpu_torch.utils.convert import _set, _to_numpy

    tree: dict = {}
    for key, tensor in state_dict.items():
        arr = _to_numpy(tensor)
        name = re.sub(r"^encoder\.", "", key)
        name = re.sub(r"^shared\.weight$", "shared.embedding", name)
        name = re.sub(r"embed_tokens\.weight$", "shared.embedding", name)
        name = re.sub(r"^block\.(\d+)\.", r"block_\1.", name)
        name = name.replace("layer.0.SelfAttention", "attention")
        name = name.replace("layer.0.layer_norm", "ln1")
        name = name.replace("layer.1.DenseReluDense", "mlp")
        name = name.replace("layer.1.layer_norm", "ln2")
        name = name.replace("mlp.wi_0", "wi_0").replace("mlp.wi_1", "wi_1")
        name = name.replace("mlp.wi", "wi").replace("mlp.wo", "wo")
        name = name.replace(
            "attention.relative_attention_bias.weight",
            "attention.relative_attention_bias.embedding")
        parts = name.split(".")
        if parts[-1] == "weight":
            _set(tree, tuple(parts[:-1]) + ("kernel",), arr.T)
        else:
            _set(tree, tuple(parts), arr)

    def fix(node):
        # an RMSNorm weight (rank 1) is a flax "scale", not a kernel
        if not isinstance(node, dict):
            return node
        return {("scale" if k == "kernel" and getattr(v, "ndim", 0) == 1
                 else k): fix(v) for k, v in node.items()}

    return fix(tree)


def t5_config_from_hf(hf: dict) -> T5Config:
    """An HF T5 ``config.json`` → :class:`T5Config` (a gated-GELU
    feed-forward for ``feed_forward_proj`` ``gated-gelu``)."""
    keys = ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
            "num_heads", "relative_attention_num_buckets",
            "relative_attention_max_distance", "layer_norm_epsilon")
    kw = {k: hf[k] for k in keys if k in hf}
    if "feed_forward_proj" in hf:
        kw["gated_act"] = hf["feed_forward_proj"].startswith("gated")
    return T5Config(**kw)
