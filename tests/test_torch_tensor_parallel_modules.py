"""Tensor parallelism's hard cases, module by module, over two ``gloo``
model ranks (``tests/_torch_tp_ranks.modules``): each sharded module's
output and the gradients of its input and of every parameter (the split
ones gathered back to full) against the same module in this process, fp32
on the CPU, within 1e-5 of the largest value (of the largest parameter
gradient, for the parameter gradients: the VAE key's bias has none, the
softmax being blind to it):

- the GEGLU feed-forward, whose in-projection ``[W_h; W_gate]`` must be
  split half by half (a plain split of the stacked rows gives rank 0 all
  of h and rank 1 all of the gate: :func:`test_a_plain_split_breaks_geglu`
  shows that it changes the output);
- the VAE's one-head mid-block attention, split on its channels, whose
  logits are all-reduced before the softmax (:func:`
  test_a_softmax_of_partial_logits_breaks_vae_attention`);
- the temporal attention with the temporal LoRA on q, k, v and out (``up``
  given non-zero weights), whose replicated LoRA weights each rank reads
  in part and whose gradients must come out whole;
- a cross-attention with IP-Adapter tokens (``to_k_ip`` / ``to_v_ip``).

One launch of the ranks for the file."""

import os

import pytest
import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.models.attention import CrossAttention
from followyourclick_tpu_torch.models.motion_module import TemporalAttention
from followyourclick_tpu_torch.models.vae import VAEAttentionBlock
from followyourclick_tpu_torch.parallel import data_parallel as dp
from followyourclick_tpu_torch.parallel.sharding import (
    local_slice,
    param_sharding_rules,
    split_specs,
)
from tests import _torch_tp_ranks
from tests._torch_tp_ranks import FF, Attn
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

RANKS = 2
REL = 1e-5


def randomised(module, seed):
    """``module`` with every parameter drawn from a seed (the LoRA's zero
    ``up`` included)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5)
    return module


def cases():
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    lora = TemporalAttention(32, heads=4, dim_head=8,
                             add_temporal_lora=True, lora_rank=4)
    ip = CrossAttention(32, heads=4, dim_head=8, cross_attention_dim=24,
                        ip_num_tokens=3, ip_scale=0.7)
    return {
        "geglu": (randomised(FF(16), 1), randn(2, 5, 16), randn(2, 5, 16),
                  {}),
        "vae_attention": (randomised(Attn(VAEAttentionBlock(16, 4)), 2),
                          randn(2, 3, 4, 16), randn(2, 3, 4, 16), {}),
        "temporal_lora": (randomised(Attn(lora), 3), randn(6, 5, 32),
                          randn(6, 5, 32), {"lora_scale": 0.8}),
        "ip_cross": (randomised(Attn(ip), 4), randn(2, 7, 32),
                     randn(2, 7, 32), {"context": randn(2, 9, 24)}),
    }


def one_process(module, x, cot, kwargs):
    x = x.clone().requires_grad_()
    y = module(x, **kwargs)
    y.backward(cot)
    return y.detach(), x.grad, {n: p.grad for n, p in
                                module.named_parameters()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tp_modules"), "job.pt")
    torch.save({"grid": (1, RANKS), "modules": cases()}, path)
    out = dp.launch(_torch_tp_ranks.modules, RANKS, (path,), timeout=120.0)
    assert not any(r["jax_loaded"] for r in out)
    return out


def close(got, want, what, scale=None):
    """Within ``REL`` of ``scale`` (``want``'s largest value by default)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max()) if scale is None else scale
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize("name", ["geglu", "vae_attention", "temporal_lora",
                                  "ip_cross"])
def test_sharded_module_equals_one_process(ranks, name):
    module, x, cot, kwargs = cases()[name]
    specs = split_specs(param_sharding_rules(module))
    assert specs, name
    y, x_grad, grads = one_process(module, x, cot, kwargs)
    for r in ranks:
        got = r[name]
        close(got["out"], y, (name, "out"))
        close(got["x_grad"], x_grad, (name, "input gradient"))
        largest = max(float(g.abs().max()) for g in grads.values())
        for n, g in grads.items():
            close(got["grads"][n], g, (name, n), largest)
        for n, p in module.named_parameters():
            assert torch.equal(got["params"][n], p.detach()), (name, n)


def test_lora_gradients_are_whole_on_every_rank(ranks):
    """The replicated LoRA weights' gradients are the sum of the ranks'
    parts, the same on both ranks and non-zero in every row of ``up``."""
    a, b = (r["temporal_lora"]["grads"] for r in ranks)
    for n in a:
        if "lora" in n:
            assert torch.equal(a[n], b[n]), n
            assert bool((a[n].abs().sum(-1) > 0).all()), n


@torch.no_grad()
def test_a_plain_split_breaks_geglu():
    """Each rank's partial output summed, with the in-projection split
    half by half (what ``shard_params`` keeps) and with a plain split of
    its stacked rows: only the first is the module's output."""
    module, x, _, _ = cases()["geglu"]
    ff = module.ff
    want = ff(x)

    def ranks_sum(halves):
        total = 0
        for r in range(RANKS):
            w = local_slice(ff.proj.weight, 0, halves, r, RANKS)
            b = local_slice(ff.proj.bias, 0, halves, r, RANKS)
            wo = local_slice(ff.out.weight, 1, 1, r, RANKS)
            h, gate = F.linear(x, w, b).chunk(2, dim=-1)
            total = total + F.linear(h * F.gelu(gate), wo)
        return total + ff.out.bias

    torch.testing.assert_close(ranks_sum(2), want, rtol=REL, atol=REL)
    assert float((ranks_sum(1) - want).abs().max()) > 0.1


@torch.no_grad()
def test_a_softmax_of_partial_logits_breaks_vae_attention():
    """The one head's logits are a sum over the channels: a softmax of each
    rank's part (no all-reduce before it) gives another output."""
    module, x, _, _ = cases()["vae_attention"]
    attn = module.attn
    want = attn(x)
    b, h, w, c = x.shape
    y = attn.group_norm(x).reshape(b, h * w, c)
    s = c ** -0.25
    total = 0
    for r in range(RANKS):
        def col(lin):
            return F.linear(y, local_slice(lin.weight, 0, 1, r, RANKS),
                            local_slice(lin.bias, 0, 1, r, RANKS))
        p = torch.softmax(col(attn.query) * s @ (col(attn.key) * s)
                          .transpose(1, 2), -1)
        total = total + F.linear(p @ col(attn.value), local_slice(
            attn.proj_attn.weight, 1, 1, r, RANKS))
    naive = (total + attn.proj_attn.bias).reshape(x.shape) + x
    assert float((naive - want).abs().max()) > 1e-2
