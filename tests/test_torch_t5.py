"""Port parity: the T5 v1.1 encoder (the second text tower) against the JAX
``T5EncoderModel``.

A tiny encoder (vocabulary 200, d_model 32, 2 layers, 4 heads of 8, d_ff 64)
with random parameters in the JAX tree (numpy, from a seed; RMSNorm scales
1 + N(0, 0.05²)), carried by ``load_jax_params``, runs the same token ids
with padded masks in fp32 on the CPU: the last hidden states hold 1e-4
(rtol and atol). The relative-position buckets are integers and must be
equal, out to 300 positions (past ``max_distance``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followyourclick_tpu.models import t5_text as jt5
from followyourclick_tpu_torch.models import t5_text as tt5
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_unet import random_tree
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

TOL = 1e-4
TINY = dict(vocab_size=200, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_heads=4)


def test_t5_config_is_the_jax_one():
    def fields(cls):
        return [(f.name, str(f.type), f.default)
                for f in dataclasses.fields(cls)]

    assert fields(tt5.T5Config) == fields(jt5.T5Config)
    assert tt5.T5Config.__module__ == "followyourclick_tpu_torch.models." \
        "t5_text"


def test_relative_position_buckets_match_jax():
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), 32,
                                                    128))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def _pair(gated=True, seed=0):
    cfg = dict(TINY, gated_act=gated)
    jmodel = jt5.T5EncoderModel(jt5.T5Config(**cfg))
    ids = jnp.zeros((2, 16), jnp.int32)
    tree = random_tree(jmodel.init, ids, jnp.ones((2, 16), jnp.int32),
                       seed=seed)
    tmodel = load_jax_params(tt5.T5EncoderModel(tt5.T5Config(**cfg)), tree)
    assert len(jax.tree_util.tree_leaves(tree)) == len(list(
        tmodel.parameters()))
    return jmodel, tree, tmodel


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_t5_encoder_matches_jax(gated, padded):
    """Two prompts of 16 tokens; with ``padded`` the second is padded after
    10 tokens and the first after 3."""
    jmodel, tree, tmodel = _pair(gated)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 200, (2, 16))
    mask = np.ones((2, 16), np.int64)
    if padded:
        mask[0, 3:] = 0
        mask[1, 10:] = 0
    want = jax.jit(jmodel.apply)({"params": tree}, jnp.asarray(ids),
                                 jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_t5_without_mask_and_padding_changes_the_states():
    """No mask attends to every token (as the JAX model); a padding mask
    changes the states of the padded prompt's tokens."""
    jmodel, tree, tmodel = _pair()
    ids = np.random.RandomState(2).randint(0, 200, (1, 12))
    want = jax.jit(jmodel.apply)({"params": tree}, jnp.asarray(ids))
    mask = np.ones((1, 12), np.int64)
    mask[0, 6:] = 0
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))
        masked = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert float((got - masked)[0, :6].abs().max()) > 1e-3


def test_position_bias_is_built_once():
    """Layer 0 holds the bias table; the later layers reuse its bias."""
    _, _, tmodel = _pair()
    assert hasattr(tmodel.block[0].attention, "relative_attention_bias")
    assert not hasattr(tmodel.block[1].attention, "relative_attention_bias")
