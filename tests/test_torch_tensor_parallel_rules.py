"""The port's sharding rules against JAX's, with no compute.

``parallel/sharding.param_sharding_rules`` must give every parameter of
the full-width UNet (the default ``UNet3DConfig``, 1.28 B parameters) and
VAE (the default ``VAEConfig``), and of a tiny UNet with every option
whose leaves carry a rule's name (IP-Adapter tokens, the T5
cross-attention, in-block temporal attention, the temporal LoRA,
``temporal_attention_dim_div``), the spec JAX's ``param_sharding_rules``
gives its flax counterpart (``utils/convert.flax_paths``), in torch
layout: JAX runs under ``jax.eval_shape``, the port on the meta device.
Also: the slices and their gathering in one process, the route's rule on
the global head count, and the one-process mesh.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from followyourclick_tpu.config import (
    MotionModuleConfig,
    UNet3DConfig,
    VAEConfig,
)
from followyourclick_tpu.models.unet3d import UNet3DConditionModel as JUNet
from followyourclick_tpu.models.unet3d import UNetConditioning as JCond
from followyourclick_tpu.models.vae import AutoencoderKL as JVAE
from followyourclick_tpu.parallel import sharding as jsharding
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.models.vae import AutoencoderKL
from followyourclick_tpu_torch.ops.attention import route
from followyourclick_tpu_torch.parallel.mesh import create_mesh
from followyourclick_tpu_torch.parallel.sharding import (
    local_slice,
    param_sharding_rules,
    shard_params,
    split_specs,
)
from followyourclick_tpu_torch.utils.convert import _jax_shape, flax_paths
from tests.test_torch_data_parallel import port_config
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

OPTIONS = UNet3DConfig(
    block_out_channels=(32, 64), down_block_types=(
        "CrossAttnDownBlock3D", "DownBlock3D"),
    up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"), layers_per_block=1,
    norm_num_groups=8, cross_attention_dim=32, use_ip_cross_attention=True,
    ip_num_tokens=4, use_text_encoder_2=True, text_encoder_2_dim=16,
    unet_use_temporal_attention=True,
    motion_module=MotionModuleConfig(num_attention_heads=4,
                                     add_temporal_lora=True,
                                     temporal_attention_dim_div=2))


def jax_specs(tree) -> dict:
    """Flax path → JAX's spec, as a tuple."""
    specs = jsharding.param_sharding_rules(tree)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(k.key for k in path): tuple(spec)
            for path, spec in flat[0]}


def unet_tree(cfg):
    ctx = 77 + (cfg.ip_num_tokens if cfg.use_ip_cross_attention else 0)
    cond = JCond(context=jnp.zeros((1, ctx, cfg.cross_attention_dim)),
                 fps=jnp.zeros((1,)), motion_score=jnp.zeros((1,)),
                 context_t5=(jnp.zeros((1, 8, cfg.text_encoder_2_dim))
                             if cfg.use_text_encoder_2 else None))
    return jax.eval_shape(JUNet(cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 2, 8, 8, 9)),
                          jnp.zeros((1,), jnp.int32), cond)["params"]


def vae_tree(cfg):
    return jax.eval_shape(JVAE(cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)),
                          jax.random.PRNGKey(1))["params"]


def port_module(kind, cfg):
    with torch.device("meta"):
        if kind == "vae":
            return AutoencoderKL(port_config(cfg))
        return UNet3DConditionModel(port_config(cfg))


CASES = {"unet_full_width": ("unet", UNet3DConfig()),
         "vae_full_width": ("vae", VAEConfig()),
         "unet_options": ("unet", OPTIONS)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rules_match_jax_on_every_leaf(case):
    kind, cfg = CASES[case]
    tree = vae_tree(cfg) if kind == "vae" else unet_tree(cfg)
    want = jax_specs(tree)
    module = port_module(kind, cfg)
    rules = param_sharding_rules(module)
    paths = flax_paths(module)
    assert set(paths.values()) == set(want), case
    owners = dict(module.named_modules())
    split = 0
    for name, spec in rules.items():
        jspec = want[paths[name]]
        mod = owners[name.rsplit(".", 1)[0]]
        p = dict(mod.named_parameters(recurse=False))[name.rsplit(".", 1)[1]]
        if paths[name][-1] == "kernel" and len(_jax_shape(mod, p)) == 2:
            jspec = jspec[::-1]   # (in, out) kernel → (out, in) weight
        if "model" not in jspec:  # replicated: (a JAX Conv1x1 kernel is
            jspec = (None,) * p.ndim  # 4-D, the port's Linear 2-D)
        assert spec == jspec, (name, spec, jspec)
        split += "model" in spec
    assert split, case
    if kind == "unet":
        # every attention and feed-forward of the full UNet splits: q, k,
        # v, out and GEGLU in / out (+ the column biases and out's bias
        # replicated)
        ff = [n for n in rules if n.endswith("ff.proj.weight")]
        assert ff and all(rules[n] == ("model", None) for n in ff)
        assert all(rules[n.replace("proj", "out")] == (None, "model")
                   for n in ff)
    if case == "unet_options":
        for leaf in ("to_k_ip.weight", "attn_t5.to_q.weight",
                     "attn_temp.to_v.weight"):
            assert any(n.endswith(leaf) and rules[n] == ("model", None)
                       for n in rules), leaf
        lora = [n for n in rules if "_lora." in n]
        assert lora and all("model" not in rules[n] for n in lora)


def test_full_width_split_counts():
    """The full UNet: every one of its 16 spatial transformer blocks and 20
    motion modules has its q, k, v, out and GEGLU weights split, nothing
    else."""
    module = port_module("unet", UNet3DConfig())
    specs = split_specs(param_sharding_rules(module))
    kinds = {}
    for n in specs:
        kinds[n.split(".")[-2]] = kinds.get(n.split(".")[-2], 0) + 1
    # spatial: attn1/attn2 q k v (no bias) + out weight, ff proj w+b, out w
    # motion: two attentions' q k v + out weight, ff proj w+b, out w
    assert kinds == {"to_q": 16 * 2 + 20 * 2, "to_k": 72, "to_v": 72,
                     "to_out": 72, "proj": 2 * 36, "out": 36}, kinds


def test_slices_and_geglu_halves():
    w = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    # a GEGLU in-projection [W_h; W_gate] of 4 + 4 rows over 2 ranks
    r0 = local_slice(w, 0, 2, 0, 2)
    r1 = local_slice(w, 0, 2, 1, 2)
    assert torch.equal(r0, w[[0, 1, 4, 5]])
    assert torch.equal(r1, w[[2, 3, 6, 7]])
    assert torch.equal(local_slice(w, 0, 1, 1, 2), w[4:])
    assert torch.equal(local_slice(w, 1, 1, 0, 3), w[:, :1])
    with pytest.raises(ValueError, match="does not split"):
        local_slice(w, 1, 1, 0, 2)


def test_route_decides_on_the_global_heads(monkeypatch):
    """``dot_product_attention`` on a rank's 4 of 8 heads routes on all 8:
    at the 2-clip level-0 self-attention (64 rows of 4096 tokens, heads of
    40) that is flash, where 4 heads alone would be plain."""
    from followyourclick_tpu_torch.ops import attention as tops

    seen = []

    def recorded(q_shape, k_shape, has_bias, impl="auto"):
        seen.append((tuple(q_shape), tuple(k_shape)))
        return "plain"

    monkeypatch.setattr(tops, "route", recorded)
    q = torch.randn(2, 5, 4, 8)
    tops.dot_product_attention(q, q, q, model_ranks=2)
    assert seen == [((2, 5, 8, 8), (2, 5, 8, 8))]
    level0 = (64, 4096, 8, 40)
    assert route(level0, level0, False) == "flash"
    assert route((64, 4096, 4, 40), (64, 4096, 4, 40), False) == "plain"
    # the frame axis: 16 frames x 8 heads stays tiny
    assert route((1024, 16, 8, 160), (1024, 16, 8, 160), False) == "tiny"


def test_one_process_mesh():
    mesh = create_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="needs a process group"):
        create_mesh(2, 2)



def test_shard_params_refuses_a_module_without_a_tp_forward():
    """CLIP's ``q_proj`` / ``mlp_fc1`` split by JAX's rules, but its layers
    run only whole weights (CLIP stays replicated, as in JAX's dry run)."""
    from followyourclick_tpu_torch.config import CLIPTextConfig
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.parallel.mesh import Mesh

    two = Mesh({"data": 1, "model": 2}, None, None, 0, 0, (0,), (0, 1))
    clip = CLIPTextModel(CLIPTextConfig(vocab_size=10, hidden_size=8,
                                        intermediate_size=16,
                                        num_hidden_layers=1,
                                        num_attention_heads=2))
    assert any("model" in s for s in param_sharding_rules(clip).values())
    with pytest.raises(NotImplementedError, match="no tensor-parallel"):
        shard_params(clip, two)
