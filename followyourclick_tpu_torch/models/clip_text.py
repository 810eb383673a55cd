"""CLIP ViT-L/14 text encoder (SD-1.5's prompt tower).

Port of ``followyourclick_tpu/models/clip_text.py``: quick-GELU MLPs, the
causal mask and the final LayerNorm. Returns ``(last_hidden_state,
pooled_output)``; the pipeline uses the first.
"""

from __future__ import annotations

import torch
from torch import nn

from followyourclick_tpu_torch.config import CLIPTextConfig
from followyourclick_tpu_torch.models.layers import LayerNorm
from followyourclick_tpu_torch.ops.attention import dot_product_attention

_ACTIVATIONS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": lambda x: torch.nn.functional.gelu(x),
}


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, d // self.heads)

        out = dot_product_attention(split(self.q_proj(x)),
                                    split(self.k_proj(x)),
                                    split(self.v_proj(x)), bias=mask)
        return self.out_proj(out.reshape(b, s, d))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _ACTIVATIONS[cfg.hidden_act]
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp_fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp_fc2(self.act(self.mlp_fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)[None]
        x = self.token_embedding(input_ids) + self.position_embedding(pos)
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=input_ids.device).tril()
        mask = torch.zeros(s, s, device=input_ids.device).masked_fill(
            ~causal, float("-inf"))[None, None]
        for layer in self.layers:
            x = layer(x, mask)
        x = self.final_layer_norm(x)
        eot = input_ids.argmax(dim=-1)  # the eot token has the highest id
        return x, x[torch.arange(b, device=x.device), eot]
