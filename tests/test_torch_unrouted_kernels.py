"""The port's three unrouted kernel modules against the JAX package's
Pallas kernels.

``ops/geglu.fused_geglu`` (the GEGLU feed-forward alone),
``ops/groupnorm.fused_group_norm`` (GroupNorm + SiLU with the kernel's
pilot-shifted statistics) and ``ops/cross_attention.fused_ln_cross_attention``
(LN → q → attention over ≤ 128 keys → out): their plain PyTorch versions,
which the wrappers run for CPU tensors, against the JAX kernels in
interpret mode (as tests/test_geglu.py, test_groupnorm.py and
test_cross_attention.py run them) and against the JAX fp32 references
``_ref_fp32``. The same numpy inputs go to both; matrices are transposed to
the port's ``nn.Linear`` layout. No path of either package routes these
kernels; tests/test_torch_cuda.py holds the CUDA kernels to these plain
versions on the card.

Tolerances: fp32 holds 2e-4 (rtol and atol), as the JAX kernel tests do:
only the order of sums differs (the GroupNorm reference takes the plain
mean where the kernels shift by a pilot, which moves fp32 sums by a few
ulps). bf16 holds 3e-2 absolute at unit-scale outputs, as
tests/test_torch_kernels.py: both sides round to bf16 at the same points,
so they differ by a few bf16 ulps, and the fp32 reference lies within the
same distance of the bf16 kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from followyourclick_tpu.models import attention as jatt
from followyourclick_tpu.ops import cross_attention as jca
from followyourclick_tpu.ops import geglu as jgeglu
from followyourclick_tpu.ops import groupnorm as jgn
from followyourclick_tpu_torch.models.attention import GEGLUFeedForward
from followyourclick_tpu_torch.ops.cross_attention import (
    fused_ln_cross_attention,
    ln_cross_attention_ref,
)
from followyourclick_tpu_torch.ops.geglu import fused_geglu, geglu_ref
from followyourclick_tpu_torch.ops.groupnorm import (
    cluster_smem,
    fused_group_norm,
    group_norm_path,
    group_norm_ref,
    two_pass_chunks,
)
from followyourclick_tpu_torch.config import InferenceConfig
from followyourclick_tpu_torch.pipelines.animation import SampleSpec
from followyourclick_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_unet import random_tree
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

FP32_TOL = 2e-4
BF16_ATOL = 3e-2
BF = jnp.bfloat16


def _np(t):
    return np.array(t.float().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(jnp.asarray(t).astype(jnp.float32)),
                    np.float32)


def _as(args, dtype):
    """numpy fp32 arrays → (JAX arrays, the same values as torch tensors)
    in ``dtype``; bf16 values round once, on the JAX side."""
    jdt = BF if dtype == torch.bfloat16 else jnp.float32
    j = [jnp.asarray(a, jdt) for a in args]
    return j, [torch.from_numpy(_np(a)).to(dtype) for a in j]


def _check(got, jk, ref, dtype):
    got = _np(got)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, _np(jk), rtol=FP32_TOL, atol=FP32_TOL)
        np.testing.assert_allclose(got, _np(ref), rtol=FP32_TOL,
                                   atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, _np(jk), atol=BF16_ATOL, rtol=0)
        np.testing.assert_allclose(got, _np(ref), atol=BF16_ATOL, rtol=0)


DTYPES = [torch.float32, torch.bfloat16]


# ---------------------------------------------------------------- GEGLU FF

def _geglu_args(rs, rows, c, inner):
    return [rs.randn(rows, c).astype(np.float32),
            (0.08 * rs.randn(c, 2 * inner)).astype(np.float32),
            (0.02 * rs.randn(2 * inner)).astype(np.float32),
            (0.08 * rs.randn(inner, c)).astype(np.float32),
            (0.02 * rs.randn(c)).astype(np.float32)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [100, 77])
@pytest.mark.parametrize("fast", [False, True], ids=["erf", "tanh"])
def test_geglu_plain_matches_jax(dtype, rows, fast):
    """77 rows are ragged against the Pallas 32-row block. The tanh gate
    rounds to bf16 inside in either dtype and is not the reference's erf, so
    it holds the bf16 bound."""
    j, t = _as(_geglu_args(np.random.RandomState(rows), rows, 32, 128),
               dtype)
    t[1], t[3] = t[1].T.contiguous(), t[3].T.contiguous()
    jk = jgeglu.fused_geglu(*j, block_r=32, interpret=True, fast_gating=fast)
    ref = jgeglu._ref_fp32(*j)
    got = geglu_ref(*t, fast_gating=fast)
    assert got.dtype == dtype and got.shape == (rows, 32)
    _check(got, jk, ref, torch.bfloat16 if fast else dtype)


def test_geglu_cpu_wrapper_is_the_plain_version():
    _, t = _as(_geglu_args(np.random.RandomState(5), 20, 32, 128),
               torch.bfloat16)
    t[1], t[3] = t[1].T.contiguous(), t[3].T.contiguous()
    before = fused_geglu.launches
    got = fused_geglu(*t)  # bf16 at C <= 640: the tanh gate by default
    torch.testing.assert_close(got, geglu_ref(*t, fast_gating=True), rtol=0,
                               atol=0)
    assert fused_geglu.launches == before


def test_geglu_feed_forward_module_matches_jax():
    """The port's module on the CPU (the plain layers; on the card it
    launches fused_geglu) against the JAX module, which off the TPU takes
    its XLA branch."""
    jm = jatt.GEGLUFeedForward(dim=32)
    x = np.random.RandomState(3).randn(2, 9, 32).astype(np.float32)
    tree = random_tree(jm.init, jnp.zeros((1, 9, 32)), seed=4)
    model = load_jax_params(GEGLUFeedForward(32), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


# ---------------------------------------------------------------- GroupNorm

def _gn_args(rs, b, n, c, offset):
    """Activations offset from zero (mean ≫ std in some groups), so the
    pilot shift matters."""
    return [(offset + rs.randn(b, n, c)).astype(np.float32),
            (1.0 + 0.1 * rs.randn(c)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,groups,offset", [
    (2, 64, 32, 8, 0.0), (3, 37, 64, 8, 4.0), (1, 100, 64, 32, -2.0)])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_plain_matches_jax(dtype, b, n, c, groups, offset, act):
    """37 rows and 3 batch rows are ragged against the Pallas 2-row batch
    block."""
    j, t = _as(_gn_args(np.random.RandomState(n + c), b, n, c, offset),
               dtype)
    jk = jgn.fused_group_norm(*j, groups=groups, eps=1e-5, act=act,
                              block_b=2, interpret=True)
    ref = jgn._ref_fp32(*j, groups, 1e-5, act)
    got = group_norm_ref(*t, groups=groups, eps=1e-5, act=act)
    assert got.dtype == dtype and got.shape == (b, n, c)
    _check(got, jk, ref, dtype)


def test_group_norm_cpu_wrapper_is_the_plain_version():
    _, t = _as(_gn_args(np.random.RandomState(1), 2, 16, 32, 1.0),
               torch.float32)
    before = fused_group_norm.launches
    got = fused_group_norm(*t, groups=8, act="silu")
    torch.testing.assert_close(got, group_norm_ref(*t, groups=8, act="silu"),
                               rtol=0, atol=0)
    assert fused_group_norm.launches == before


# (B, N, C) of the 20 GroupNorm site shapes of one exact evaluation at 16 f
# / 512² with CFG (chip_smoke.group_norm_sites) and the path each takes in
# bf16 and in fp32: every per-frame site (B = 16, 32) and the resnet sites
# at (2, 1024, 1280), batch rows of at most 2.62 MB in bf16, run on the
# cluster path in bf16, each in the fewest blocks (a power of two) that
# hold it, at least 2 a row at B = 32; fp32 keeps only the per-frame rows
# of at most 1.31 MB there
GN_SITE_PATHS = {
    (1, 65536, 320): ("two_pass", "two_pass"),
    (16, 4096, 320): (("cluster", 16), "two_pass"),
    (2, 1024, 1280): (("cluster", 16), "two_pass"),
    (2, 1024, 2560): ("two_pass", "two_pass"),
    (2, 16384, 1280): ("two_pass", "two_pass"),
    (2, 16384, 1920): ("two_pass", "two_pass"),
    (2, 16384, 320): ("two_pass", "two_pass"),
    (2, 16384, 640): ("two_pass", "two_pass"),
    (2, 16384, 960): ("two_pass", "two_pass"),
    (2, 4096, 1280): ("two_pass", "two_pass"),
    (2, 4096, 1920): ("two_pass", "two_pass"),
    (2, 4096, 2560): ("two_pass", "two_pass"),
    (2, 4096, 640): ("two_pass", "two_pass"),
    (2, 65536, 320): ("two_pass", "two_pass"),
    (2, 65536, 640): ("two_pass", "two_pass"),
    (2, 65536, 960): ("two_pass", "two_pass"),
    (32, 1024, 640): (("cluster", 8), ("cluster", 16)),
    (32, 256, 1280): (("cluster", 4), ("cluster", 8)),
    (32, 4096, 320): (("cluster", 16), "two_pass"),
    (32, 64, 1280): (("cluster", 2), ("cluster", 2)),
}


def test_group_norm_site_table_is_the_models():
    sites = chip_smoke.group_norm_sites(InferenceConfig().unet, SampleSpec())
    assert sum(sites.values()) == 81
    assert {key[:3] for key in sites} == set(GN_SITE_PATHS)


def _check_path(path, want, b, n, c, dtype):
    kind, count, rows = path
    if want == "two_pass":
        assert kind == "two_pass"
        assert count == two_pass_chunks(n, rows) and count % 8 == 0
        assert (count - 8) * rows < n <= count * rows
    else:
        assert (kind, count) == want
        assert rows == -(-n // count)
        assert cluster_smem(rows, c, dtype) <= 232448


@pytest.mark.parametrize("b,n,c", sorted(GN_SITE_PATHS))
def test_group_norm_path_at_every_site(b, n, c):
    """The path is a function of (B, N, C, dtype) alone."""
    for dtype, want in zip((torch.bfloat16, torch.float32),
                           GN_SITE_PATHS[(b, n, c)]):
        _check_path(group_norm_path(b, n, c, dtype), want, b, n, c, dtype)


# the largest N whose batch row 16 blocks hold: rows · C · bytes plus the
# scratch, (2 · row groups + 5) · C fp32 words (row groups 6 at C =
# 320, 2 at 1280, 1 at 2560), within the 232,448 bytes of a block
@pytest.mark.parametrize("c,dtype,n", [(320, torch.bfloat16, 5264),
                                       (1280, torch.bfloat16, 1152),
                                       (2560, torch.bfloat16, 496),
                                       (320, torch.float32, 2624)])
def test_group_norm_path_at_the_on_chip_limit(c, dtype, n):
    rows = n // 16
    assert cluster_smem(rows, c, dtype) <= 232448
    assert cluster_smem(rows + 1, c, dtype) > 232448
    assert group_norm_path(2, n, c, dtype) == ("cluster", 16, rows)
    _check_path(group_norm_path(2, n + 1, c, dtype), "two_pass", 2, n + 1, c,
                dtype)


def test_group_norm_path_spreads_small_calls():
    """Rows that fit one block still spread over a cluster until the call
    spans 64 blocks, as far as N allows; N = 1 takes one block."""
    assert group_norm_path(2, 64, 320, torch.bfloat16) == ("cluster", 16, 4)
    assert group_norm_path(32, 37, 64, torch.bfloat16) == ("cluster", 2, 19)
    assert group_norm_path(64, 37, 64, torch.bfloat16) == ("cluster", 1, 37)
    assert group_norm_path(3, 1, 2560, torch.float32) == ("cluster", 1, 1)


# -------------------------------------------------- LN → cross-attention

def _cross_args(rs, b, s, c, skv, ck):
    return [rs.randn(b, s, c).astype(np.float32),
            rs.randn(b, skv, ck).astype(np.float32),
            (1.0 + 0.1 * rs.randn(c)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32),
            (0.1 * rs.randn(c, c)).astype(np.float32),
            (0.1 * rs.randn(ck, c)).astype(np.float32),
            (0.1 * rs.randn(ck, c)).astype(np.float32),
            (0.1 * rs.randn(c, c)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32)]


def _cross_torch(t):
    """JAX (in, out) matrices → nn.Linear (out, in)."""
    for i in (4, 5, 6, 7):
        t[i] = t[i].T.contiguous()
    return t


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("skv", [7, 77])
def test_cross_attention_plain_matches_jax(dtype, skv):
    """40 query rows are ragged against the 16-row Pallas block."""
    b, s, c, heads, ck = 3, 40, 32, 4, 24
    j, t = _as(_cross_args(np.random.RandomState(skv), b, s, c, skv, ck),
               dtype)
    scale = (c // heads) ** -0.5
    jk = jca.fused_ln_cross_attention(*j, heads=heads, block_s=16,
                                      interpret=True)
    ref = jca._ref_fp32(*j, heads, scale, 1e-5)
    got = ln_cross_attention_ref(*_cross_torch(t), heads=heads)
    assert got.dtype == dtype and got.shape == (b, s, c)
    _check(got, jk, ref, dtype)


def test_cross_attention_rejects_more_than_128_keys():
    _, t = _as(_cross_args(np.random.RandomState(0), 1, 8, 32, 129, 24),
               torch.float32)
    with pytest.raises(ValueError, match="Skv <= 128"):
        fused_ln_cross_attention(*_cross_torch(t), heads=4)


def test_cross_attention_cpu_wrapper_is_the_plain_version():
    _, t = _as(_cross_args(np.random.RandomState(2), 2, 12, 32, 7, 24),
               torch.bfloat16)
    t = _cross_torch(t)
    before = fused_ln_cross_attention.launches
    got = fused_ln_cross_attention(*t, heads=4)
    torch.testing.assert_close(got, ln_cross_attention_ref(*t, heads=4),
                               rtol=0, atol=0)
    assert fused_ln_cross_attention.launches == before


def test_unrouted_wrappers_raise_off_cpu_and_cuda():
    meta = [torch.empty(1, device="meta")]
    with pytest.raises(ValueError):
        fused_geglu(torch.empty(4, 32, device="meta"), *meta * 4)
    with pytest.raises(ValueError):
        fused_group_norm(torch.empty(2, 4, 32, device="meta"), *meta * 2,
                         groups=8)
    with pytest.raises(ValueError):
        fused_ln_cross_attention(
            torch.empty(2, 4, 32, device="meta"),
            torch.empty(2, 7, 24, device="meta"),
            *[torch.empty(32, 32, device="meta")] * 7, heads=4)
