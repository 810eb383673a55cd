"""Port parity: the motion-module options (RoPE, temporal LoRA, ``_Cross``
block types, ``temporal_attention_dim_div``) and the route each one takes.

The JAX modules and the port run the same numpy inputs in fp32 on the CPU,
parameters carried by ``load_jax_params``. Every leaf is random
(``tests/test_torch_unet.random_tree``), so the zero-initialised LoRA ``up``
and ``proj_out`` move the output. RoPE tables and rotations hold 1e-4 (one
fp32 product and sum); the motion modules 2e-4, as in
``tests/test_torch_attention.py`` (a few matmuls and a softmax summed in
another order).

The routes are asserted on a stand-in card: the module runs on tensors whose
``device`` says "cuda" (a ``torch.Tensor`` subclass, factories sent to the
CPU), with every routed kernel wrapper replaced by a counter around its
plain version (``chip_smoke.wrappers_replaced``). The counts are the JAX
rule's: the whole-block kernel for a standard block only, then
``fused_temporal_block`` for an attention without RoPE or LoRA at inner
width = C < 1280, else ``dot_product_attention``, whose tiny-sequence route
(F ≤ 32) is ``temporal_attention``; and the output still matches the JAX
module.
"""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke
from followyourclick_tpu.config import MotionModuleConfig
from followyourclick_tpu.models import motion_module as jm
from followyourclick_tpu.models import rope as jrope
from followyourclick_tpu_torch.models import motion_module as tm
from followyourclick_tpu_torch.models import rope as trope
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_unet import random_tree

TOL = 2e-4
ROPE_TOL = 1e-4


class CudaLike(torch.Tensor):
    """A CPU tensor whose ``device`` says "cuda": the port's modules take
    their card routes on it."""

    @property
    def device(self):
        return torch.device("cuda")


class _CpuFactories(TorchFunctionMode):
    """Tensors a module makes on its input's device (tables, indices) are
    made on the CPU."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cuda":
            kwargs["device"] = "cpu"
        return func(*args, **kwargs)


@contextlib.contextmanager
def stand_in_card():
    """Within the block the routed kernel wrappers count their calls (the
    yielded Counter; its ``calls`` list holds each call's wrapper name and
    the dtypes and shapes of its tensor arguments) and run their plain
    versions; factories with a cuda device make CPU tensors. Wrap the
    inputs with ``.as_subclass(CudaLike)``."""
    counts = collections.Counter()
    counts.calls = []
    plain = chip_smoke.plain_versions()

    def make(name, _):
        def stand_in(*a, **k):
            counts[name] += 1
            counts.calls.append((name, [(t.dtype, tuple(t.shape)) for t in a
                                        if isinstance(t, torch.Tensor)]))
            return plain[name](*a, **k)
        return stand_in

    with chip_smoke.wrappers_replaced(make), _CpuFactories():
        yield counts


def np_tree(module, *args, seed=0):
    return random_tree(module.init, *args, seed=seed)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dim,length,ntk", [(8, 8, 0.0), (40, 24, 0.0),
                                            (20, 16, 4.0)])
def test_rope_tables_and_rotation_match_jax(dim, length, ntk):
    """cos / sin tables (NTK base at α = 4) and the rotation of q and k,
    with the log-scaled query beyond the 16 trained frames (F = 24)."""
    cos, sin = trope.rope_tables(dim, length, ntk_alpha=ntk)
    jcos, jsin = jrope.rope_tables(dim, length, ntk_alpha=ntk)
    close(cos, jcos, ROPE_TOL)
    close(sin, jsin, ROPE_TOL)
    rs = np.random.RandomState(dim)
    q, k = (rs.randn(3, 2, length, dim).astype(np.float32) for _ in range(2))
    got = trope.apply_rope(t(q), t(k), cos, sin, train_video_length=16)
    want = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin,
                            train_video_length=16)
    for g, w in zip(got, want):
        close(g, w, ROPE_TOL)


# (name, MotionModuleConfig overrides, frames)
OPTIONS = [
    ("rope_f8", dict(use_rope_position_encoding=True), 8),
    ("rope_f24", dict(use_rope_position_encoding=True), 24),
    ("lora", dict(add_temporal_lora=True, lora_rank=4), 8),
    ("cross", dict(attention_block_types=("Temporal_Self",
                                          "Temporal_Cross")), 8),
    ("dim_div2", dict(temporal_attention_dim_div=2), 8),
    ("rope_lora_div2", dict(use_rope_position_encoding=True,
                            add_temporal_lora=True,
                            temporal_attention_dim_div=2), 24),
]


def _module_pair(overrides, frames, c=64, seed=0):
    cfg = MotionModuleConfig(num_attention_heads=4,
                             temporal_position_encoding_max_len=32,
                             **overrides)
    x = np.random.RandomState(frames).randn(2, frames, 3, 2, c).astype(
        np.float32)
    jmod = jm.MotionModule(in_channels=c, config=cfg)
    tree = np_tree(jmod, jnp.asarray(x), seed=seed)
    tmod = load_jax_params(tm.MotionModule(c, cfg), tree)
    want = jmod.apply({"params": tree}, jnp.asarray(x))
    return tmod, tree, x, want


@pytest.mark.parametrize("name,overrides,frames", OPTIONS,
                         ids=[o[0] for o in OPTIONS])
def test_motion_module_option_matches_jax(name, overrides, frames):
    tmod, tree, x, want = _module_pair(overrides, frames)
    assert len(jax.tree_util.tree_leaves(tree)) == len(list(
        tmod.parameters()))
    with torch.no_grad():
        close(tmod(t(x)), want)


@pytest.mark.parametrize("lora_scale", [0.0, 0.5, 2.0])
def test_temporal_lora_scale_matches_jax(lora_scale):
    """One temporal attention with LoRA at ``lora_scale`` (the JAX
    ``TemporalAttention.__call__`` argument; the blocks pass 1.0)."""
    rs = np.random.RandomState(3)
    x = rs.randn(6, 8, 32).astype(np.float32)
    jattn = jm.TemporalAttention(query_dim=32, heads=4, dim_head=8,
                                 add_temporal_lora=True, lora_rank=4)
    tree = random_tree(lambda key, x: jattn.init(key, x, video_length=8),
                       jnp.asarray(x), seed=4)
    want = jattn.apply({"params": tree}, jnp.asarray(x), video_length=8,
                       lora_scale=lora_scale)
    tattn = load_jax_params(tm.TemporalAttention(
        32, 4, 8, add_temporal_lora=True, lora_rank=4), tree)
    with torch.no_grad():
        close(tattn(t(x), lora_scale=lora_scale), want)


def test_fresh_lora_and_rope_modules_start_as_their_inits():
    """The LoRA ``up`` starts at zero (the projection alone), and a fresh
    module with RoPE carries no position table to load."""
    attn = tm.TemporalAttention(32, 4, 8, add_temporal_lora=True,
                                use_rope=True)
    assert not attn.to_q_lora.up.weight.any()
    assert attn.to_q_lora.down.weight.std() > 0.1
    x = torch.randn(3, 8, 32)
    with torch.no_grad():
        base = tm.TemporalAttention(32, 4, 8, use_rope=True)
        base.load_state_dict(attn.state_dict(), strict=False)
        torch.testing.assert_close(attn(x), base(x))


F32, BF16 = torch.float32, torch.bfloat16


# (name, overrides, frames, dtype, PAB mode, launches of the whole-block
# kernel, fused_temporal_block, temporal_attention, fused_ln_geglu) for one
# module of one block at C = 64 (4 heads of 16, 8 with dim_div 2)
# (the fp32 whole-block fit asks the built kernel for its occupancy, so the
# standard block's kernel route is checked in bf16)
ROUTES = [
    ("standard_bf16", {}, 8, BF16, None, (1, 0, 0, 0)),
    ("standard_pab", {}, 8, F32, PabMode(record_temporal=True),
     (0, 2, 0, 1)),
    ("rope_f8", OPTIONS[0][1], 8, F32, None, (0, 0, 2, 1)),
    ("rope_f24_bf16", OPTIONS[1][1], 24, BF16, None, (0, 0, 2, 1)),
    ("lora", OPTIONS[2][1], 8, F32, None, (0, 0, 2, 1)),
    ("cross", OPTIONS[3][1], 8, F32, None, (0, 2, 0, 1)),
    ("dim_div2", OPTIONS[4][1], 8, BF16, None, (0, 0, 2, 1)),
    ("dim_div2_pab", OPTIONS[4][1], 8, F32,
     PabMode(record_temporal=True), (0, 0, 2, 1)),
]
ROUTED = ("fused_motion_block", "fused_temporal_block", "temporal_attention",
          "fused_ln_geglu")


@pytest.mark.parametrize("name,overrides,frames,dtype,pab,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_motion_option_routes_as_jax(name, overrides, frames, dtype, pab,
                                     want):
    """On the stand-in card each option launches what the JAX rule picks;
    in fp32 the module still matches JAX."""
    tmod, _, x, jwant = _module_pair(overrides, frames)
    tmod = tmod.to(dtype)
    with torch.no_grad(), stand_in_card() as counts:
        got = tmod(t(x).to(dtype).as_subclass(CudaLike), pab, {})
    assert tuple(counts[n] for n in ROUTED) == want, dict(counts)
    assert counts["flash_attention"] == 0
    if dtype == F32:
        close(got.as_subclass(torch.Tensor), jwant)


def test_one_frame_rope_module_matches_jax():
    """RoPE at a single frame (the video_scale per-frame pass): the rotation
    at position 0 is the identity."""
    tmod, _, x, want = _module_pair(OPTIONS[0][1], 1)
    with torch.no_grad():
        close(tmod(t(x)), want)


def test_motion_module_config_options_are_all_taken():
    """No MotionModuleConfig option raises any more."""
    cfg = MotionModuleConfig(num_attention_heads=4,
                             use_rope_position_encoding=True,
                             add_temporal_lora=True,
                             temporal_attention_dim_div=2,
                             attention_block_types=("Temporal_Cross",
                                                    "Temporal_Cross"))
    blk = tm.MotionModule(64, cfg).transformer_blocks[0]
    assert blk.head_dim == 8
    assert blk.attention_blocks[0].to_q.out_features == 32
    assert blk.attention_blocks[1].to_out_lora.up.out_features == 64
