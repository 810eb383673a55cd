"""Port parity: attention dispatch, the spatial transformer (with the CFG
prefix-sharing split) and the motion module.

Same numpy inputs through the JAX modules and the port, parameters carried
by ``load_jax_params``, fp32 on the CPU. The JAX motion module runs both its
modular path and its fused path (``FYC_FORCE_FUSED_MOTION=1``: the Pallas
kernel in interpret mode); the port on the CPU runs its modular path, which
is the plain path of its kernel. Tolerance 2e-4 (rtol and atol): chains of
a few matmuls and a softmax whose sums are taken in another order, as in
tests/test_motion_block.py (5e-4 there between the JAX paths themselves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.config import MotionModuleConfig
from followyourclick_tpu.models import attention as ja
from followyourclick_tpu.models import motion_module as jm
from followyourclick_tpu.ops import attention as jops
from followyourclick_tpu_torch.models import attention as ta
from followyourclick_tpu_torch.models import motion_module as tm
from followyourclick_tpu_torch.ops import attention as tops
from followyourclick_tpu_torch.utils.convert import load_jax_params

TOL = 2e-4


def np_tree(variables):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  variables["params"])


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,masked", [(16, 16, False), (20, 77, False),
                                          (77, 77, True)])
def test_dot_product_attention(sq, sk, masked):
    rs = np.random.RandomState(sq + sk)
    q = rs.randn(3, sq, 4, 8).astype(np.float32)
    k, v = (rs.randn(3, sk, 4, 8).astype(np.float32) for _ in range(2))
    bias = None
    if masked:  # the CLIP causal mask
        bias = np.where(np.tri(sq, sk, dtype=bool), 0.0, -np.inf).astype(
            np.float32)[None, None]
    got = tops.dot_product_attention(t(q), t(k), t(v),
                                     None if bias is None else t(bias))
    want = jops.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v),
                                      None if bias is None
                                      else jnp.asarray(bias))
    close(got, want, 1e-5)


def test_unported_routes_raise_only_on_the_card():
    """A CPU tensor takes the plain route at every shape; the routing test
    itself is on the shapes, so it is checked with a stand-in device."""
    q = torch.zeros(2, 16, 8, 4)
    assert tops.dot_product_attention(q, q, q).shape == q.shape

    class CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    tiny = torch.zeros(2, 16, 8, 4).as_subclass(CudaLike)
    with pytest.raises(NotImplementedError, match="temporal_attention"):
        tops.dot_product_attention(tiny, tiny, tiny)
    huge = torch.zeros(1, 1, 1, 4).expand(4096, 4096, 8, 4).as_subclass(
        CudaLike)  # 4096·8·4096²·2 B of bf16 scores > 12 GiB
    with pytest.raises(NotImplementedError, match="flash_attention"):
        tops.dot_product_attention(huge, huge, huge)


@pytest.mark.parametrize("cfg_batch", [1, 2])
def test_basic_transformer_block(cfg_batch):
    """cfg_batch=2: hidden states at batch B meet context at 2B, and both
    sides duplicate at the first cross-attention ([h; h])."""
    rs = np.random.RandomState(cfg_batch)
    h = rs.randn(3, 10, 32).astype(np.float32)
    ctx = rs.randn(3 * cfg_batch, 7, 48).astype(np.float32)
    jb = ja.BasicTransformerBlock(dim=32, num_attention_heads=4,
                                  attention_head_dim=8,
                                  cross_attention_dim=48)
    tree = np_tree(jb.init(jax.random.PRNGKey(0), jnp.asarray(h),
                           context=jnp.asarray(ctx)))
    tb = load_jax_params(ta.BasicTransformerBlock(32, 4, 8, 48), tree)
    got = tb(t(h), t(ctx))
    assert got.shape[0] == 3 * cfg_batch
    close(got, jb.apply({"params": tree}, jnp.asarray(h),
                        context=jnp.asarray(ctx)))


@pytest.mark.parametrize("cfg_batch", [1, 2])
def test_spatial_transformer(cfg_batch):
    rs = np.random.RandomState(10 + cfg_batch)
    x = rs.randn(1, 3, 4, 5, 32).astype(np.float32)
    ctx = rs.randn(cfg_batch, 7, 48).astype(np.float32)
    js = ja.SpatialTransformer3D(in_channels=32, num_attention_heads=4,
                                 attention_head_dim=8, cross_attention_dim=48,
                                 norm_num_groups=8)
    tree = np_tree(js.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(ctx)))
    ts = load_jax_params(ta.SpatialTransformer3D(32, 4, 8, 1, 48, 8), tree)
    close(ts(t(x), t(ctx)),
          js.apply({"params": tree}, jnp.asarray(x), jnp.asarray(ctx)))


def test_geglu_feed_forward_is_the_kernel_plain_path():
    """The model's plain LN → FF → +h equals the kernel's plain version."""
    from followyourclick_tpu_torch.ops.geglu import ln_geglu_ref

    torch.manual_seed(0)
    norm, ff = ta.LayerNorm(32), ta.GEGLUFeedForward(32)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1)
        norm.bias.normal_(0.0, 0.1)
    h = torch.randn(2, 9, 32)
    want = ln_geglu_ref(h.reshape(-1, 32), norm.weight, norm.bias,
                        ff.proj.weight, ff.proj.bias, ff.out.weight,
                        ff.out.bias).reshape(h.shape)
    close(ta._ln_ff_residual(norm, ff, h), want.detach(), 1e-5)


@pytest.mark.parametrize("force_fused", ["0", "1"])
@pytest.mark.parametrize("f,pe", [(4, True), (5, False)])
def test_motion_module(monkeypatch, force_fused, f, pe):
    monkeypatch.setenv("FYC_FORCE_FUSED_MOTION", force_fused)
    cfg = MotionModuleConfig(num_attention_heads=4,
                             temporal_position_encoding=pe,
                             temporal_position_encoding_max_len=8,
                             zero_initialize=False)
    x = np.random.RandomState(f).randn(2, f, 3, 4, 32).astype(np.float32)
    jmod = jm.MotionModule(in_channels=32, config=cfg)
    tree = np_tree(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tmod = load_jax_params(tm.MotionModule(32, cfg), tree)
    close(tmod(t(x)), jmod.apply({"params": tree}, jnp.asarray(x)))


def test_motion_module_rejects_unported_options():
    for bad in (dict(use_rope_position_encoding=True),
                dict(add_temporal_lora=True),
                dict(attention_block_types=("Temporal_Self",
                                            "Temporal_Cross"))):
        with pytest.raises(NotImplementedError):
            tm.MotionModule(32, MotionModuleConfig(num_attention_heads=4,
                                                   **bad))


def test_fused_params_order_matches_the_kernel():
    """The 20-tuple the block hands the kernel, against the JAX order."""
    blk = tm.TemporalTransformerBlock(32, 4, 8)
    p = blk.fused_params()
    assert len(p) == 20
    assert p[2] is blk.attention_blocks[0].to_q.weight
    assert p[12] is blk.attention_blocks[1].to_out.weight
    assert p[16] is blk.ff.proj.weight and p[19] is blk.ff.out.bias
