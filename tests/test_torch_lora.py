"""The port's LoRA merges (``utils/lora.py``) against the JAX package's.

Each LoRA merges into the JAX parameter tree by ``followyourclick_tpu.
utils.lora`` and the tree crosses by ``load_jax_params``; the same LoRA
merges in place into the port's modules loaded from the unmerged tree.
Every parameter must then agree exactly: the delta is the same fp32 numpy
product, added in fp32 (torch keeps the (out, in) layout, JAX the
transposed kernel). Tiny configs: the UNet of ``tests/test_torch_unet.py``
and its 2-layer CLIP text encoder.
"""

import re

import jax
import numpy as np
import pytest
import torch

from followyourclick_tpu.utils.lora import merge_motion_lora as jax_motion
from followyourclick_tpu.utils.lora import merge_sd_lora as jax_sd
from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
from followyourclick_tpu_torch.models.motion_module import TemporalAttention
from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
from followyourclick_tpu_torch.utils.convert import load_jax_params
from followyourclick_tpu_torch.utils.lora import (
    merge_motion_lora,
    merge_sd_lora,
)
from tests.test_torch_unet import (
    TINY_CLIP,
    TINY_UNET,
    tiny_clip_tree,
    tiny_unet_tree,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


def motion_lora(unet_config, rank=4, seed=0, scale=0.5):
    """A camera-motion LoRA in the reference key format
    (``...motion_modules.N.temporal_transformer.transformer_blocks.0.
    attention_blocks.M.processor.to_{q,k,v,out}_lora.{down,up}.weight``)
    over every motion module's attention projections, from a numpy seed."""
    rs = np.random.RandomState(seed)
    with torch.device("meta"):
        unet = UNet3DConditionModel(unet_config)
    sd = {}
    for name, mod in unet.named_modules():
        if not isinstance(mod, TemporalAttention):
            continue
        base = re.sub(r"(motion_modules\.\d+\.)", r"\1temporal_transformer.",
                      name)
        c = mod.to_q.in_features
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            key = f"{base}.processor.{proj}_lora"
            sd[f"{key}.down.weight"] = (rs.randn(rank, c) / np.sqrt(c)
                                        ).astype(np.float32)
            sd[f"{key}.up.weight"] = (scale * rs.randn(c, rank)
                                      / np.sqrt(rank)).astype(np.float32)
    return sd


def _assert_same(module, tree):
    """Every parameter of ``module`` equals the tree's, crossed."""
    want = load_jax_params(type(module)(module.config), tree)
    for (name, got), (_, ref) in zip(module.named_parameters(),
                                     want.named_parameters()):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=name)


def _fp32(tree):
    """The tree in fp32, the port's parameter dtype (``random_tree`` leaves
    some kernels in float64, where the JAX merge would add in float64)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def unet_tree():
    return _fp32(tiny_unet_tree())


def test_motion_lora_matches_jax(unet_tree):
    sd = motion_lora(TINY_UNET)
    unet = load_jax_params(UNet3DConditionModel(TINY_UNET), unet_tree)
    before = {n: p.clone() for n, p in unet.named_parameters()}
    assert merge_motion_lora(unet, sd, alpha=0.8) is unet
    _assert_same(unet, jax_motion(unet_tree, sd, alpha=0.8))
    moved = [n for n, p in unet.named_parameters()
             if not torch.equal(p, before[n])]
    assert len(moved) == len(sd) // 2
    assert all("attention_blocks" in n and n.endswith(".weight")
               for n in moved)


def _kohya(rs, name, out_dim, in_dim, rank=4, conv=None):
    """A kohya LoRA pair (and its ``alpha`` entry, which the merge skips):
    linear, or ``conv=(kh, kw)``."""
    if conv is None:
        down = rs.randn(rank, in_dim) / np.sqrt(in_dim)
        up = rs.randn(out_dim, rank) / np.sqrt(rank)
    else:
        down = rs.randn(rank, in_dim, *conv) / np.sqrt(in_dim)
        up = rs.randn(out_dim, rank, 1, 1) / np.sqrt(rank)
    return {f"{name}.lora_down.weight": down.astype(np.float32),
            f"{name}.lora_up.weight": up.astype(np.float32),
            f"{name}.alpha": np.float32(rank)}


def test_sd_lora_matches_jax(unet_tree):
    """Linear layers by their kohya names with every rename (``to_out_0``,
    ``ff_net_0_proj``, ``ff_net_2``, ``text_model_encoder_layers``), a 1×1
    conv LoRA on ``proj_in`` (a linear layer in the port, a 1×1 conv kernel
    in JAX) and a 3×3 conv LoRA on an upsampler's conv, into the UNet and
    the text encoder together."""
    rs = np.random.RandomState(3)
    blk = "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0"
    te = "lora_te_text_model_encoder_layers_1"
    sd = {}
    for name, o, i, conv in (
            (f"{blk}_attn1_to_q", 64, 64, None),
            (f"{blk}_attn2_to_k", 64, 768, None),
            (f"{blk}_attn2_to_out_0", 64, 64, None),
            (f"{blk}_ff_net_0_proj", 512, 64, None),
            (f"{blk}_ff_net_2", 64, 256, None),
            ("lora_unet_down_blocks_1_attentions_0_proj_in", 64, 64,
             (1, 1)),
            ("lora_unet_up_blocks_1_upsamplers_0_conv", 64, 64, (3, 3)),
            (f"{te}_self_attn_q_proj", 768, 768, None),
            (f"{te}_mlp_fc1", 512, 768, None)):
        sd.update(_kohya(rs, name, o, i, conv=conv))
    clip_tree = _fp32(tiny_clip_tree())
    unet = load_jax_params(UNet3DConditionModel(TINY_UNET), unet_tree)
    text = load_jax_params(CLIPTextModel(TINY_CLIP), clip_tree)
    got_unet, got_text = merge_sd_lora(unet, text, sd, alpha=0.6)
    assert got_unet is unet and got_text is text
    want_unet, want_text = jax_sd(unet_tree, clip_tree, sd, alpha=0.6)
    _assert_same(unet, want_unet)
    _assert_same(text, want_text)


@pytest.mark.parametrize("name", [
    "lora_unet_down_blocks_1_attentions_0_no_such_layer",
    "lora_unet_down_blocks_0_resnets_0_conv1"],
    ids=["unknown_layer", "no_kernel"])
def test_unresolvable_kohya_name_raises(unet_tree, name):
    """A name that resolves to no module raises ``KeyError``, and so does
    one that resolves to a module without a kernel (an inflated conv, whose
    kernel sits one level down), as in JAX."""
    sd = _kohya(np.random.RandomState(0), name, 32, 32, conv=(3, 3))
    with pytest.raises(KeyError):
        jax_sd(unet_tree, None, sd)
    unet = load_jax_params(UNet3DConditionModel(TINY_UNET), unet_tree)
    with pytest.raises(KeyError):
        merge_sd_lora(unet, None, sd)


def test_qkv_cache_follows_the_merge(unet_tree):
    """The bf16 kernels read ``[Wq; Wk; Wv]`` from a cache keyed on the
    weights' storage and version: built before a merge, it is rebuilt after
    it, equal to the concatenation of the merged weights."""
    unet = load_jax_params(UNet3DConditionModel(TINY_UNET), unet_tree)
    attns = [m for m in unet.modules() if isinstance(m, TemporalAttention)]
    stale = [a.qkv_weight() for a in attns]
    merge_motion_lora(unet, motion_lora(TINY_UNET), alpha=1.0)
    for a, old in zip(attns, stale):
        new = a.qkv_weight()
        assert new is not old
        torch.testing.assert_close(new, torch.cat(
            [a.to_q.weight, a.to_k.weight, a.to_v.weight]), rtol=0, atol=0)
        assert not torch.equal(new, old)
