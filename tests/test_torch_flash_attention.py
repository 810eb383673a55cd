"""The port's flash attention against the JAX Pallas kernel, and the route.

``flash_attention_ref`` (the plain version of ``csrc/flash_attention.cu``)
and ``flash_attention`` on a CPU tensor (which runs that plain version) get
the same numpy inputs as the JAX ``flash_attention``, run in TPU interpret
mode as ``tests/test_flash_attention.py`` runs it (blocks of 128, so the
online softmax walks several key blocks and masks a ragged last one), and
as the JAX ``_xla_attention``. fp32 holds 1e-4 absolute on unit-normal
inputs: the same math, with the softmax's sums taken in another order and,
in the Pallas kernel, at a running max. bf16 holds 1.6e-2 of the largest
output (two bf16 ulps): both round p to bf16 before p·v, but at different
maxima (the Pallas kernel's per key block, the plain version's global one),
and both round the output.

The routing rule (:func:`route`) is a function of the shapes alone and is
checked without allocating the shapes it names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from followyourclick_tpu.ops import attention as jops
from followyourclick_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from followyourclick_tpu_torch.ops import attention as tops
from followyourclick_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

FP32_ATOL = 1e-4
BF16_REL = 1.6e-2

# (B, Sq, Sk, H, D): the JAX tests' shapes, and cross-attention of 256
# queries over 77 keys
SHAPES = [(2, 128, 128, 4, 40), (2, 300, 300, 4, 64), (1, 512, 512, 2, 160),
          (2, 256, 77, 4, 40)]


def _inputs(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed + sq + sk + d)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, h, d).astype(np.float32)
    v = rs.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                        block_q=128, block_k=128)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_plain_version_matches_the_pallas_kernel_fp32(b, sq, sk, h, d):
    q, k, v = _inputs(b, sq, sk, h, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = tfa.flash_attention_ref(tq, tk, tv)
    wrapped = tfa.flash_attention(tq, tk, tv)  # a CPU tensor: the plain path
    assert ref.shape == (b, sq, h, d) and ref.dtype == torch.float32
    assert torch.equal(ref, wrapped)
    want = _jax_flash(q, k, v)
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=FP32_ATOL)
    xla = np.asarray(jops._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), None, d ** -0.5))
    np.testing.assert_allclose(ref.numpy(), xla, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_plain_version_matches_the_pallas_kernel_bf16(b, sq, sk, h, d):
    q, k, v = _inputs(b, sq, sk, h, d, seed=1)
    # round the inputs to bf16 once, so both sides start from equal values
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in (q, k, v))
    got = tfa.flash_attention_ref(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = _jax_flash(q, k, v, jnp.bfloat16)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_REL, err


def test_plain_version_chunks_batch_heads(monkeypatch):
    """B·H = 24 rows in chunks of 5 (the plain version's memory bound at the
    path shape) give what one chunk gives, and what the JAX kernel gives."""
    q, k, v = _inputs(3, 128, 200, 8, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    whole = tfa.flash_attention_ref(tq, tk, tv)
    monkeypatch.setattr(tfa, "REF_CHUNK_BYTES", 5 * 128 * 200 * 4)
    chunked = tfa.flash_attention_ref(tq, tk, tv)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(chunked.numpy(), _jax_flash(q, k, v), rtol=0,
                               atol=FP32_ATOL)


@pytest.mark.parametrize("q_shape,k_shape,bias,impl,want", [
    # level-0 spatial self-attention of a 2-clip CFG request: 16 GiB
    ((64, 4096, 8, 40), (64, 4096, 8, 40), False, "auto", "flash"),
    # before the CFG duplication, or one clip: 8 GiB
    ((32, 4096, 8, 40), (32, 4096, 8, 40), False, "auto", "plain"),
    # exactly 12 GiB is not above the line
    ((48, 4096, 8, 40), (48, 4096, 8, 40), False, "auto", "plain"),
    ((49, 4096, 8, 40), (49, 4096, 8, 40), False, "auto", "flash"),
    ((64, 4096, 8, 40), (64, 4096, 8, 40), True, "auto", "plain"),
    # short keys (text cross-attention) never take flash
    ((4096, 4096, 8, 40), (4096, 77, 8, 40), False, "auto", "plain"),
    ((2000, 4096, 8, 40), (2000, 1000, 8, 40), False, "auto", "plain"),
    # the motion module's frame axis at C = 1280
    ((512, 16, 8, 160), (512, 16, 8, 160), False, "auto", "tiny"),
    ((512, 16, 8, 160), (512, 16, 8, 160), True, "auto", "plain"),
    ((2, 256, 4, 40), (2, 77, 4, 40), False, "flash", "flash"),
    ((512, 16, 8, 160), (512, 16, 8, 160), False, "flash", "flash"),
    ((2, 256, 4, 40), (2, 77, 4, 40), True, "flash", "plain"),
    ((64, 4096, 8, 40), (64, 4096, 8, 40), False, "xla", "plain"),
    ((512, 16, 8, 160), (512, 16, 8, 160), False, "xla", "plain"),
])
def test_route(q_shape, k_shape, bias, impl, want):
    assert tops.route(q_shape, k_shape, bias, impl) == want


def test_route_rejects_unported_and_unknown_impls():
    """"packed" (the JAX head-packed formulation, ported as plain PyTorch)
    takes its own route, bias or not; an impl the JAX package does not know
    raises."""
    assert tops.route((2, 16, 8, 40), (2, 16, 8, 40), False,
                      "packed") == "packed"
    assert tops.route((2, 16, 8, 40), (2, 16, 8, 40), True,
                      "packed") == "packed"
    with pytest.raises(ValueError):
        tops.route((2, 16, 8, 40), (2, 16, 8, 40), False, "cudnn")


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_impl_by_name_on_the_cpu(impl):
    """impl="flash" runs the flash plain version, held to the JAX flash
    kernel (interpret mode); impl="xla" the plain route, held to XLA."""
    q, k, v = _inputs(2, 256, 77, 4, 40, seed=3)
    got = tops.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), impl=impl).numpy()
    j = [jnp.asarray(a) for a in (q, k, v)]
    if impl == "flash":
        with pltpu.force_tpu_interpret_mode():
            want = jops.dot_product_attention(*j, impl="flash")
    else:
        want = jops.dot_product_attention(*j, impl="xla")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FP32_ATOL)
