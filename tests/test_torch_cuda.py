"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere. The file
imports no JAX, so it runs on a machine without it; there, skip the suite's
conftest, which imports JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are unit normal, weights N(0, 1/fan_in), norm scales 1 + N(0, 0.05²).
The error is normalised: max |kernel - plain| / max |plain|. fp32 holds
1e-4: only the summation order differs. bf16, and the tanh gate in either
dtype (it rounds to bf16 inside), hold 1.6e-2, two bf16 ulps of the largest
output: both sides round to bf16 at the same points, but the plain version
rounds each product to bf16 before adding its fp32 bias and sums in another
order, so single values land an ulp or two apart; measured relative to each
value instead, a residual add that cancels (8 - 6) would magnify that ulp.
"""

import copy

import numpy as np
import pytest
import torch

from followyourclick_tpu_torch.config import MotionModuleConfig
from followyourclick_tpu_torch.models.motion_module import MotionModule
from followyourclick_tpu_torch.models.pab import PabMode
from followyourclick_tpu_torch.models.attention import GEGLUFeedForward
from followyourclick_tpu_torch.ops.attention import dot_product_attention
from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops import cross_attention as ca
from followyourclick_tpu_torch.ops.cross_attention import (
    fused_ln_cross_attention,
    ln_cross_attention_ref,
)
from followyourclick_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
)
from followyourclick_tpu_torch.ops.geglu import (
    down_bf16,
    down_stage,
    fused_geglu,
    fused_ln_geglu,
    geglu_ref,
    layer_norm_cast,
    ln_geglu_ref,
    ln_rows_bf16,
    up_bf16,
    up_stage,
)
from followyourclick_tpu_torch.ops.groupnorm import (
    fused_group_norm,
    group_norm_path,
    group_norm_ref,
    launch_cluster,
    launch_two_pass,
)
from followyourclick_tpu_torch.ops.motion_block import (
    attention_bf16,
    attention_stage,
    fused_motion_block,
    ln_pe_stage,
    motion_block_ref,
    qkv_bf16,
    qkv_stage,
    qkv_weights,
)
from followyourclick_tpu_torch.ops.temporal_attention import (
    fused_temporal_block,
    temporal_attention,
    temporal_attention_ref,
    temporal_block_ref,
)

pytestmark = pytest.mark.cuda

FP32_REL = 1e-4
BF16_REL = 1.6e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _randn(rs, shape, s=1.0, dtype=torch.float32, device="cuda"):
    return torch.from_numpy((s * rs.randn(*shape)).astype(np.float32)).to(
        device, dtype)


def ln_geglu_args(rs, rows, c, dtype, device="cuda"):
    inner = 4 * c
    return [_randn(rs, (rows, c), 1.0, dtype, device),
            1.0 + _randn(rs, (c,), 0.05, dtype, device),
            _randn(rs, (c,), 0.05, dtype, device),
            _randn(rs, (2 * inner, c), c ** -0.5, dtype, device),
            _randn(rs, (2 * inner,), 0.02, dtype, device),
            _randn(rs, (c, inner), inner ** -0.5, dtype, device),
            _randn(rs, (c,), 0.02, dtype, device)]


def motion_block_args(rs, p, f, c, dtype, device="cuda"):
    def mk(shape, s):
        return _randn(rs, shape, s, dtype, device)

    vec, mat = (c,), (c, c)
    params = []
    for _ in range(2):
        params += [1.0 + mk(vec, 0.05), mk(vec, 0.05)] + [
            mk(mat, c ** -0.5) for _ in range(4)] + [mk(vec, 0.02)]
    params += [1.0 + mk(vec, 0.02), mk(vec, 0.02), mk((8 * c, c), c ** -0.5),
               mk((8 * c,), 0.02), mk((c, 4 * c), (4 * c) ** -0.5),
               mk(vec, 0.02)]
    return mk((p, f, c), 1.0), mk((f, c), 0.5), params


def assert_close(got, ref, bound):
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert float(err) <= bound, (float(err), bound)


def _bound(dtype, fast):
    return FP32_REL if dtype == torch.float32 and not fast else BF16_REL


# (rows, C): the four widths of the path (320, 640, 1280 and the tiny 64),
# row counts off the 128-row tile, C = 40, whose k-extent is off the 64-wide
# k-slice of the bf16 products, and more row tiles (313) than the card has
# SMs, so the persistent blocks walk several tiles each
GEGLU_SHAPES = [(77, 64), (1000, 320), (300, 1280), (1000, 640), (130, 1280),
                (50, 40), (40000, 320)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", GEGLU_SHAPES)
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("residual", [True, False])
def test_ln_geglu_kernel_matches_plain(card, dtype, rows, c, fast, residual):
    args = ln_geglu_args(np.random.RandomState(rows), rows, c, dtype)
    before = fused_ln_geglu.launches
    got = fused_ln_geglu(*args, residual=residual, fast_gating=fast).float()
    torch.cuda.synchronize()
    assert fused_ln_geglu.launches == before + 1
    ref = ln_geglu_ref(*args, residual=residual, fast_gating=fast).float()
    assert_close(got, ref, _bound(dtype, fast))


F32, BF16 = torch.float32, torch.bfloat16


# fp32 fits one block's shared memory up to C = 320 at 16 frames (the tiny
# configs and tests); the path's widths run in bf16
@pytest.mark.parametrize("dtype,p,f,c,heads", [
    (F32, 13, 16, 64, 4), (F32, 37, 5, 32, 4), (F32, 40, 16, 320, 8),
    (F32, 7, 24, 64, 4), (BF16, 13, 16, 64, 4), (BF16, 37, 5, 32, 4),
    (BF16, 40, 16, 320, 8), (BF16, 7, 24, 320, 8), (BF16, 9, 16, 640, 8)])
@pytest.mark.parametrize("fast", [False, True])
def test_motion_block_kernel_matches_plain(card, dtype, p, f, c, heads,
                                           fast):
    x, pe, params = motion_block_args(np.random.RandomState(p), p, f, c,
                                      dtype)
    scale = (c // heads) ** -0.5
    before = fused_motion_block.launches
    got = fused_motion_block(x, pe, params, scale, heads,
                             fast_gating=fast).float()
    assert fused_motion_block.launches == before + 1
    ref = motion_block_ref(x, pe, params, scale, heads,
                           fast_gating=fast).float()
    assert_close(got, ref, _bound(dtype, fast))


def test_motion_block_bf16_at_1280(card):
    x, pe, params = motion_block_args(np.random.RandomState(3), 8, 16, 1280,
                                      torch.bfloat16)
    got = fused_motion_block(x, pe, params, 160 ** -0.5, 8).float()
    ref = motion_block_ref(x, pe, params, 160 ** -0.5, 8).float()
    assert_close(got, ref, BF16_REL)


# The video_scale per-frame pass: one frame per position (F = 1, the frame
# attention's keys padded to a 16-key step and masked past the first), at
# its position counts and widths (16 frames of 64², 32², 16², 8² folded into
# the positions). bf16 takes every width; fp32 only C = 320: at 640 and
# 1280 one position's block overflows the all-on-chip kernel's shared
# memory even at one frame, so the route says no and the wrapper refuses
# (the model's modular path takes those blocks).
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("p,c", [(65536, 320), (16384, 640), (4096, 1280),
                                 (1024, 1280)])
def test_motion_block_at_one_frame(card, dtype, p, c):
    from followyourclick_tpu_torch.ops.motion_block import fits

    heads = 8
    x, pe, params = motion_block_args(np.random.RandomState(c), p, 1, c,
                                      dtype)
    if dtype == F32 and c >= 640:
        assert not fits(1, c, heads, dtype)
        with pytest.raises(ValueError, match="not taken"):
            fused_motion_block(x, pe, params, (c // heads) ** -0.5, heads)
        return
    assert fits(1, c, heads, dtype)
    fast = dtype == BF16 and c <= 640
    before = fused_motion_block.launches
    got = fused_motion_block(x, pe, params, (c // heads) ** -0.5, heads,
                             fast_gating=fast).float()
    assert fused_motion_block.launches == before + 1
    ref = motion_block_ref(x, pe, params, (c // heads) ** -0.5, heads,
                           fast_gating=fast).float()
    assert_close(got, ref, _bound(dtype, fast))


def test_merged_lora_reaches_the_bf16_kernel(card):
    """A motion LoRA merged after a bf16 evaluation built the modules'
    ``[Wq; Wk; Wv]`` caches: the next evaluation launches the whole-block
    kernel on rebuilt caches and gives what a copy of the merged module,
    with no cache, gives, bit for bit."""
    from followyourclick_tpu_torch.utils.lora import merge_motion_lora

    torch.manual_seed(2)
    mm = MotionModule(320, MotionModuleConfig(zero_initialize=False)).to(
        "cuda", BF16)
    x = _randn(np.random.RandomState(2), (1, 16, 8, 8, 320), 1.0, BF16)
    rs = np.random.RandomState(3)
    lora = {}
    for i in range(2):
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            key = (f"transformer_blocks.0.attention_blocks.{i}.processor."
                   f"{proj}_lora")
            lora[f"{key}.down.weight"] = rs.randn(4, 320).astype(
                np.float32) / 18
            lora[f"{key}.up.weight"] = rs.randn(320, 4).astype(np.float32)
    block = mm.transformer_blocks[0]
    with torch.no_grad():
        before_merge = mm(x)
        stale = block.qkv_weights()
        merge_motion_lora(mm, lora)
        fresh = copy.deepcopy(mm)
        for a in fresh.transformer_blocks[0].attention_blocks:
            a._qkv_key = a._qkv = None
        launches = fused_motion_block.launches
        got, want = mm(x), fresh(x)
        torch.cuda.synchronize()
    assert fused_motion_block.launches == launches + 2
    for a, old in zip(block.attention_blocks, stale):
        new = a.qkv_weight()
        assert not torch.equal(new, old)
        assert torch.equal(new, torch.cat([a.to_q.weight, a.to_k.weight,
                                           a.to_v.weight]))
    assert torch.equal(got, want)
    assert float((got - before_merge).abs().max()) > 1e-2


# The bf16 block's launches one by one, each against its plain version on
# the same inputs (the kernels' own outputs feed the next stage), at a small
# shape and at the C = 640 path shape (head width 80), both gate forms; each
# holds the bf16 tolerance above.
@pytest.mark.parametrize("p,f,c,heads", [(13, 16, 64, 4), (2048, 16, 640, 8)])
def test_motion_block_stages_match_plain(card, p, f, c, heads):
    x, pe, params = motion_block_args(np.random.RandomState(c), p, f, c,
                                      torch.bfloat16)
    r, scale = p * f, (c // heads) ** -0.5
    h = x.view(r, c)

    def empty(width=c):
        return torch.empty(r, width, dtype=x.dtype, device=x.device)

    ls, lb, _, _, _, wo, bo = params[:7]
    t = empty()
    ln_rows_bf16(h, ls, lb, t, 1e-5, pe)
    assert_close(t, ln_pe_stage(x, ls, lb, pe, 1e-5).view(r, c), BF16_REL)
    wqkv = qkv_weights(params)[0]
    q, k, v = empty(), empty(), empty()
    qkv_bf16(t, wqkv, q, k, v)
    for got, want in zip((q, k, v), qkv_stage(t, wqkv)):
        assert_close(got, want, BF16_REL)
    o = empty()
    attention_bf16(q, k, v, o, f, heads, scale)
    assert_close(o, attention_stage(q.view(p, f, c), k.view(p, f, c),
                                    v.view(p, f, c), scale, heads).view(r, c),
                 BF16_REL)
    h1 = empty()
    down_bf16(o, wo, bo, h, h1)
    assert_close(h1, down_stage(o, wo, bo, h), BF16_REL)
    lfs, lfb, w1, b1, w2, b2 = params[14:20]
    tn = empty()
    ln_rows_bf16(h1, lfs, lfb, tn, 1e-5)
    assert_close(tn, layer_norm_cast(h1, lfs, lfb, 1e-5), BF16_REL)
    for fast in (False, True):
        y, out = empty(4 * c), empty()
        up_bf16(tn, w1, b1, y, fast)
        assert_close(y, up_stage(tn, w1, b1, fast), BF16_REL)
        down_bf16(y, w2, b2, h1, out)
        assert_close(out, down_stage(y, w2, b2, h1), BF16_REL)
    torch.cuda.synchronize()


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    args = ln_geglu_args(np.random.RandomState(0), 8, 64, torch.float32)
    with pytest.raises(ValueError):
        fused_ln_geglu(args[0].t(), *args[1:])          # not (R, C) rows
    with pytest.raises(TypeError):
        fused_ln_geglu(*[a.half() for a in args])       # no fp16 kernel
    odd = ln_geglu_args(np.random.RandomState(0), 8, 36, torch.bfloat16)
    with pytest.raises(ValueError):                     # bf16 rows of TMA
        fused_ln_geglu(*odd)                            # need C % 8 == 0
    x, pe, params = motion_block_args(np.random.RandomState(0), 4, 16, 640,
                                      torch.float32)
    with pytest.raises(ValueError):                     # fp32 at 640 does
        fused_motion_block(x, pe, params, 0.1, 8)       # not fit on chip
    x, pe, params = motion_block_args(np.random.RandomState(0), 4, 16, 36,
                                      torch.bfloat16)
    with pytest.raises(ValueError):                     # bf16 rows of TMA
        fused_motion_block(x, pe, params, 0.5, 4)       # need C % 8 == 0


# every head width of the paths and tests (D) at frame counts on both sides
# of the bf16 kernel's 16-row M tile (S); the head counts vary the heads a
# block's tile takes (all 8, or a divisor of 6, 3 or 2 where the tile
# would exceed its shared-memory aim)
TA_HEADS = {8: 8, 16: 6, 40: 8, 64: 2, 80: 8, 160: 3}
TA_SHAPES = [(3 + s % 4, s, TA_HEADS[d], d) for s in (1, 4, 5, 16, 17, 32)
             for d in TA_HEADS]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,h,d", TA_SHAPES)
def test_temporal_attention_kernel_matches_plain(card, dtype, b, s, h, d):
    rs = np.random.RandomState(b * s + d)
    q, k, v = (_randn(rs, (b, s, h, d), 1.0, dtype) for _ in range(3))
    before = temporal_attention.launches
    got = temporal_attention(q, k, v)
    assert temporal_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert_close(got, temporal_attention_ref(q, k, v),
                 FP32_REL if dtype == F32 else BF16_REL)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [4, 6, 8, 40])
def test_temporal_attention_kernel_takes_odd_widths_and_offsets(card, dtype,
                                                                d):
    """Head rows that are not whole 16-byte chunks (D = 4, 6 in bf16; 6 in
    fp32) and tensors that start off a 16-byte boundary take the kernel's
    element loads; each agrees with the plain version."""
    rs = np.random.RandomState(d)
    shape = (9, 16, 4, d)
    n = int(np.prod(shape))
    q, k, v = (_randn(rs, (n + 1,), 1.0, dtype)[1:].view(shape)
               for _ in range(3))
    got = temporal_attention(q, k, v)
    assert_close(got, temporal_attention_ref(q, k, v),
                 FP32_REL if dtype == F32 else BF16_REL)


def temporal_block_args(rs, b, f, c, dtype, device="cuda"):
    return [_randn(rs, (b, f, c), 1.0, dtype, device)] + [
        _randn(rs, (c, c), c ** -0.5, dtype, device) for _ in range(4)] + [
        _randn(rs, (c,), 0.02, dtype, device)]


# fp32 at C = 640 is the shape the fp32 motion modules route here
@pytest.mark.parametrize("dtype,b,f,c,heads", [
    (F32, 6, 16, 320, 8), (F32, 3, 16, 640, 8), (F32, 5, 5, 64, 4),
    (F32, 3, 32, 64, 4), (BF16, 6, 16, 320, 8), (BF16, 3, 16, 640, 8),
    (BF16, 5, 5, 64, 4), (BF16, 9, 32, 320, 8)])
def test_temporal_block_kernel_matches_plain(card, dtype, b, f, c, heads):
    args = temporal_block_args(np.random.RandomState(b + c), b, f, c, dtype)
    before = fused_temporal_block.launches
    got = fused_temporal_block(*args, heads=heads)
    assert fused_temporal_block.launches == before + 1
    assert_close(got, temporal_block_ref(*args, heads=heads),
                 FP32_REL if dtype == F32 else BF16_REL)


# The bf16 block's three launches one by one, each against its plain stage
# on the same inputs (the kernels' own outputs feed the next stage), at a
# small shape and at the C = 640 path shape (head width 80); the wrapper
# with the module's concatenated weight against the plain block
@pytest.mark.parametrize("p,f,c,heads", [(13, 16, 64, 4), (2048, 16, 640, 8)])
def test_temporal_block_stages_match_plain(card, p, f, c, heads):
    x, wq, wk, wv, wo, bo = temporal_block_args(
        np.random.RandomState(c), p, f, c, torch.bfloat16)
    r, scale = p * f, (c // heads) ** -0.5
    wqkv = torch.cat((wq, wk, wv))
    q, k, v = torch.empty(3, r, c, dtype=x.dtype, device=x.device)
    qkv_bf16(x.view(r, c), wqkv, q, k, v)
    for got, want in zip((q, k, v), qkv_stage(x.view(r, c), wqkv)):
        assert_close(got, want, BF16_REL)
    o = torch.empty_like(q)
    attention_bf16(q, k, v, o, f, heads, scale)
    assert_close(o, attention_stage(q.view(p, f, c), k.view(p, f, c),
                                    v.view(p, f, c), scale, heads).view(r, c),
                 BF16_REL)
    out = torch.empty_like(q)
    down_bf16(o, wo, bo, None, out)
    assert_close(out, down_stage(o, wo, bo, None), BF16_REL)
    before = fused_temporal_block.launches
    got = fused_temporal_block(x, wq, wk, wv, wo, bo, heads=heads, qkv=wqkv)
    assert fused_temporal_block.launches == before + 1
    assert_close(got, temporal_block_ref(x, wq, wk, wv, wo, bo, heads=heads),
                 BF16_REL)
    torch.cuda.synchronize()


def test_temporal_wrappers_reject_what_the_kernels_do_not_take(card):
    rs = np.random.RandomState(0)
    q = _randn(rs, (2, 16, 4, 8))
    with pytest.raises(TypeError):
        temporal_attention(q.half(), q.half(), q.half())   # no fp16 kernel
    long = _randn(rs, (2, 33, 4, 8))
    with pytest.raises(ValueError):
        temporal_attention(long, long, long)                # S > 32
    with pytest.raises(ValueError):
        temporal_attention(q, q[:1], q)                     # shapes differ
    with pytest.raises(ValueError):
        temporal_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))               # not contiguous
    args = temporal_block_args(rs, 2, 16, 64, torch.float32)
    with pytest.raises(TypeError):
        fused_temporal_block(*[a.half() for a in args], heads=4)
    with pytest.raises(ValueError):
        fused_temporal_block(args[0], args[1][:32], *args[2:], heads=4)
    with pytest.raises(ValueError):
        fused_temporal_block(_randn(rs, (2, 33, 64)), *args[1:], heads=4)
    big = temporal_block_args(rs, 2, 16, 1280, torch.float32)
    with pytest.raises(ValueError):                     # fp32 at 1280 does
        fused_temporal_block(*big, heads=8)             # not fit on chip
    odd = temporal_block_args(rs, 2, 16, 36, torch.bfloat16)
    with pytest.raises(ValueError):                     # bf16 rows of the
        fused_temporal_block(*odd, heads=4)             # GEMM core need
                                                        # C % 8 == 0


def _counts():
    return [fn.launches for fn in (fused_motion_block, fused_temporal_block,
                                   temporal_attention, fused_ln_geglu)]


@pytest.mark.parametrize("c,dtype,pab,want", [
    # fp32 at C >= 640 does not fit the whole-block kernel: the modular path
    (640, F32, None, [0, 2, 0, 1]),
    (1280, F32, None, [0, 0, 2, 1]),
    # blocks that fit take the whole-block kernel, unless the temporal
    # sites record or reuse
    (640, BF16, None, [1, 0, 0, 0]), (1280, BF16, None, [1, 0, 0, 0]),
    (320, F32, PabMode(record_temporal=True), [0, 2, 0, 1]),
    (1280, BF16, PabMode(record_temporal=True), [0, 0, 2, 1])])
def test_motion_module_routes_on_the_card(card, c, dtype, pab, want):
    """One motion module (64 positions, 16 frames) on the card against its
    plain run on the CPU, with the kernels each route launches."""
    torch.manual_seed(c)
    cpu = MotionModule(c, MotionModuleConfig(zero_initialize=False)).to(
        dtype)
    gpu = copy.deepcopy(cpu).to("cuda")
    x = _randn(np.random.RandomState(c), (1, 16, 8, 8, c), 1.0, dtype, "cpu")
    with torch.no_grad():
        want_out = cpu(x, pab, {})
        before = _counts()
        got = gpu(x.cuda(), pab, {})
        torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == want
    assert_close(got.cpu(), want_out, FP32_REL if dtype == F32 else BF16_REL)


# (B, Sq, Sk, H, D): the JAX tests' shapes (ragged 300, cross-attention 256
# over 77 keys, the widest head 160), a query tile past Sq (100) and one
# batch-head count above a few blocks
FLASH_SHAPES = [(2, 128, 128, 4, 40), (2, 300, 300, 4, 64),
                (2, 256, 77, 4, 40), (1, 512, 512, 2, 160),
                (3, 100, 1030, 2, 8), (4, 1024, 1024, 8, 40),
                # queries and keys off the 128-row tiles at each head width
                # the bf16 kernel pads to (48, 64, 96, 128, 160), and a
                # large batch x heads
                (2, 77, 300, 3, 160), (1, 300, 77, 2, 96),
                (2, 200, 129, 2, 128), (3, 77, 77, 5, 64),
                (64, 256, 300, 8, 40)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,sq,sk,h,d", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(card, dtype, b, sq, sk, h, d):
    rs = np.random.RandomState(sq + sk + d)
    q = _randn(rs, (b, sq, h, d), 1.0, dtype)
    k, v = (_randn(rs, (b, sk, h, d), 1.0, dtype) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert_close(got, flash_attention_ref(q, k, v),
                 FP32_REL if dtype == F32 else BF16_REL)


def test_flash_attention_by_name_launches_the_kernel(card):
    """dot_product_attention(impl="flash") at a shape "auto" keeps on the
    plain route; impl="xla" never launches."""
    rs = np.random.RandomState(1)
    q, k, v = (_randn(rs, (2, 256, 4, 40), 1.0, BF16) for _ in range(3))
    before = flash_attention.launches
    got = dot_product_attention(q, k, v, impl="flash")
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_ref(q, k, v), BF16_REL)
    plain = dot_product_attention(q, k, v, impl="xla")
    assert flash_attention.launches == before + 1
    assert_close(plain, flash_attention_ref(q, k, v), BF16_REL)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(card):
    rs = np.random.RandomState(0)
    q = _randn(rs, (2, 64, 4, 40))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())       # no fp16 kernel
    with pytest.raises(ValueError):
        flash_attention(q, q[:1], q[:1])                    # batch differs
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))                  # not contiguous
    odd = _randn(rs, (2, 64, 4, 36))
    with pytest.raises(ValueError):
        flash_attention(odd, odd, odd)                      # D % 8 != 0
    wide = _randn(rs, (1, 64, 1, 168))
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)                   # D > 160


@pytest.mark.parametrize("schedule", [None, "pab244_deep4_cfg4_ex"])
def test_two_clip_tiny_request_card_against_cpu(card, schedule):
    """A tiny fp32 request of two different clips (64², 4 frames) on the
    card (kernels) against the same request on the CPU (plain versions):
    2e-3 on the [0, 1] video, as chip_smoke.py's tiny phase."""
    import chip_smoke
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
        SampleSpec,
    )
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )

    torch.manual_seed(2)
    cfg = chip_smoke.tiny_config()
    cpu = AnimationPipeline(cfg, device="cpu")
    chip_smoke.unzero_(cpu.unet, torch.Generator().manual_seed(2))
    gpu = AnimationPipeline(cfg, copy.deepcopy(cpu.unet),
                            copy.deepcopy(cpu.vae),
                            copy.deepcopy(cpu.text_encoder))
    assert gpu.device.type == "cuda"
    spec = SampleSpec(video_length=4, height=64, width=64,
                      num_inference_steps=2 if schedule is None else 6)
    if schedule is not None:
        spec = apply_schedule(spec, schedule)
    with torch.inference_mode():
        req = chip_smoke.make_request(cpu, spec, 3, 1000, batch=2)
    want = cpu.sample(spec=spec, **req)
    got = gpu.sample(spec=spec, **req)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 4, 64, 64, 3)
    assert float((want[0] - want[1]).abs().mean()) > 1e-3
    assert float((got.cpu() - want).abs().max()) <= chip_smoke.TINY_VIDEO_ATOL


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,c", GEGLU_SHAPES)
@pytest.mark.parametrize("fast", [False, True])
def test_geglu_kernel_matches_plain(card, dtype, rows, c, fast):
    """fused_geglu: the LN-off, residual-off mode of the LN-GEGLU kernel."""
    args = ln_geglu_args(np.random.RandomState(rows + 1), rows, c, dtype)
    ff = [args[0]] + args[3:]
    before = fused_geglu.launches
    got = fused_geglu(*ff, fast_gating=fast)
    assert fused_geglu.launches == before + 1
    assert_close(got, geglu_ref(*ff, fast_gating=fast), _bound(dtype, fast))


def test_geglu_feed_forward_module_launches_on_the_card(card):
    """GEGLUFeedForward takes the kernel on a CUDA tensor (exact erf gate
    in fp32, as its CPU layers)."""
    torch.manual_seed(0)
    cpu = GEGLUFeedForward(64)
    x = _randn(np.random.RandomState(4), (2, 9, 64), 1.0, F32, "cpu")
    with torch.no_grad():
        want = cpu(x)
        before = fused_geglu.launches
        got = copy.deepcopy(cpu).cuda()(x.cuda())
    assert fused_geglu.launches == before + 1
    assert_close(got.cpu(), want, FP32_REL)


# (B, N, C, groups, act): the tiny configs, ragged N, a site of each UNet
# width (C = 2560 owns two vectors a thread), and a batch of frames
GROUP_NORM_SHAPES = [(2, 64, 32, 8, None), (3, 37, 64, 8, "silu"),
                     (1, 4096, 320, 32, "silu"), (2, 1024, 2560, 32, "silu"),
                     (32, 256, 1280, 32, None), (2, 1000, 640, 32, None)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,n,c,groups,act", GROUP_NORM_SHAPES)
def test_group_norm_kernel_matches_plain(card, dtype, b, n, c, groups, act):
    rs = np.random.RandomState(n + c)
    x = _randn(rs, (b, n, c), 1.0, dtype) + 2.0
    scale = 1.0 + _randn(rs, (c,), 0.05, dtype)
    bias = _randn(rs, (c,), 0.05, dtype)
    before = fused_group_norm.launches
    got = fused_group_norm(x, scale, bias, groups, 1e-5, act)
    again = fused_group_norm(x, scale, bias, groups, 1e-5, act)
    assert fused_group_norm.launches == before + 2
    assert torch.equal(got, again)  # no float atomics: bit for bit
    assert_close(got, group_norm_ref(x, scale, bias, groups, 1e-5, act),
                 FP32_REL if dtype == F32 else BF16_REL)


def cross_args(rs, b, s, c, skv, dtype, ck=768):
    return [_randn(rs, (b, s, c), 1.0, dtype),
            _randn(rs, (b, skv, ck), 1.0, dtype),
            1.0 + _randn(rs, (c,), 0.05, dtype), _randn(rs, (c,), 0.05, dtype),
            _randn(rs, (c, c), c ** -0.5, dtype),
            _randn(rs, (c, ck), ck ** -0.5, dtype),
            _randn(rs, (c, ck), ck ** -0.5, dtype),
            _randn(rs, (c, c), c ** -0.5, dtype),
            _randn(rs, (c,), 0.02, dtype)]


# (B, S, C, heads, Skv): D = 16, 40, 80 and 160, ragged rows, 7 / 77 / 128
# keys; fp32 at C = 1280 does not fit one block's shared memory (the
# wrapper raises, tested below)
CROSS_SHAPES = [(2, 100, 64, 4, 7), (3, 333, 320, 8, 77),
                (2, 256, 640, 8, 77), (2, 50, 320, 8, 128)]


@pytest.mark.parametrize("dtype,b,s,c,heads,skv", [
    (dtype, *shape) for dtype in (F32, BF16) for shape in CROSS_SHAPES]
    + [(BF16, 2, 64, 1280, 8, 77)])
def test_cross_attention_kernel_matches_plain(card, dtype, b, s, c, heads,
                                              skv):
    args = cross_args(np.random.RandomState(s + skv), b, s, c, skv, dtype)
    before = fused_ln_cross_attention.launches
    got = fused_ln_cross_attention(*args, heads=heads)
    assert fused_ln_cross_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, c)
    assert_close(got, ln_cross_attention_ref(*args, heads=heads),
                 FP32_REL if dtype == F32 else BF16_REL)


# The bf16 call's four launches one by one, each against its plain stage on
# the same inputs (the kernels' own outputs feed the next stage), then the
# wrapper against the plain call twice, bit for bit: D = 40, 80, 160 and 16,
# Skv = 77, 128, 1 and 7, S off the 128-row tiles; at 32 x 2000 an
# attention block walks several query tiles (two buffers), the last ragged
@pytest.mark.parametrize("b,s,c,heads,skv", [(2, 333, 320, 8, 77),
                                             (2, 256, 640, 8, 128),
                                             (2, 200, 1280, 8, 1),
                                             (3, 100, 64, 4, 7),
                                             (32, 2000, 320, 8, 77)])
def test_cross_attention_stages_match_plain(card, b, s, c, heads, skv):
    args = cross_args(np.random.RandomState(c + skv), b, s, c, skv, BF16)
    x, ctx, ls, lb, wq, wk, wv, wo, bo = args
    r, scale = b * s, (c // heads) ** -0.5
    k, v = ca.project_kv(ctx, wk, wv)
    xn = torch.empty_like(x)
    ln_rows_bf16(x.view(r, c), ls, lb, xn.view(r, c), 1e-5)
    assert_close(xn, layer_norm_cast(x, ls, lb, 1e-5), BF16_REL)
    q = torch.empty_like(x)
    ca.linear_bf16(xn.view(r, c), wq, q.view(r, c))
    assert_close(q, ca.q_stage(xn, wq), BF16_REL)
    o = torch.empty_like(q)
    ca.attention_bf16(q, k, v, o, heads, scale)
    assert_close(o, ca.attention_stage(q, k, v, heads, scale), BF16_REL)
    out = torch.empty_like(x)
    down_bf16(o.view(r, c), wo, bo, None, out.view(r, c))
    assert_close(out, down_stage(o, wo, bo, None), BF16_REL)
    before = fused_ln_cross_attention.launches
    got = fused_ln_cross_attention(*args, heads=heads)
    again = fused_ln_cross_attention(*args, heads=heads)
    assert fused_ln_cross_attention.launches == before + 2
    assert torch.equal(got, again)
    assert_close(got, ln_cross_attention_ref(*args, heads=heads), BF16_REL)
    torch.cuda.synchronize()


# the four attn2 shapes of the 16-frame 512² CFG step: 32 rows of 64², 32²,
# 16² and 8² tokens over 77 keys of 768 channels, 8 heads
@pytest.mark.parametrize("s,c", [(4096, 320), (1024, 640), (256, 1280),
                                 (64, 1280)])
def test_cross_attention_at_the_attn2_shapes(card, s, c):
    args = cross_args(np.random.RandomState(s), 32, s, c, 77, BF16)
    before = fused_ln_cross_attention.launches
    got = fused_ln_cross_attention(*args, heads=8)
    assert fused_ln_cross_attention.launches == before + 1
    assert_close(got, ln_cross_attention_ref(*args, heads=8), BF16_REL)


def _group_norm_args(rs, b, n, c, dtype):
    return (_randn(rs, (b, n, c), 1.0, dtype) + 2.0,
            1.0 + _randn(rs, (c,), 0.05, dtype), _randn(rs, (c,), 0.05, dtype))


# Each path forced, on (B, N, C, groups): C = 320, 960, 2560 with 10 and 80
# channels a group, N = 1, and N off every chunk and row tile; the cluster
# path takes 16 blocks of rows (1 at N = 1), the two-pass path 24 chunks
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("path", ["cluster", "two_pass"])
@pytest.mark.parametrize("b,n,c,groups,act", [
    (2, 1, 320, 32, None), (3, 333, 320, 32, "silu"),
    (2, 37, 960, 12, "silu"), (1, 700, 960, 96, None),
    (2, 201, 2560, 32, "silu"), (2, 77, 2560, 256, None)])
def test_group_norm_paths_match_plain(card, dtype, path, b, n, c, groups,
                                      act):
    x, scale, bias = _group_norm_args(np.random.RandomState(n + c), b, n, c,
                                      dtype)
    outs = [torch.empty_like(x) for _ in range(2)]
    for out in outs:
        if path == "cluster":
            cs = 16 if n >= 16 else 1
            launch_cluster(x, scale, bias, groups, 1e-5, act, cs, -(-n // cs),
                           out)
        else:
            launch_two_pass(x, scale, bias, groups, 1e-5, act,
                            max(1, -(-n // 24)), out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])  # no float atomics: bit for bit
    assert_close(outs[0], group_norm_ref(x, scale, bias, groups, 1e-5, act),
                 FP32_REL if dtype == F32 else BF16_REL)


# the slabs just inside and just outside the cluster path's limit (16 blocks
# of 227 KB), through the wrapper, which counts one launch a call
@pytest.mark.parametrize("n,c,dtype,want", [
    (5264, 320, BF16, "cluster"), (5265, 320, BF16, "two_pass"),
    (1152, 1280, BF16, "cluster"), (1153, 1280, BF16, "two_pass"),
    (2624, 320, F32, "cluster"), (2625, 320, F32, "two_pass")])
def test_group_norm_at_the_on_chip_limit(card, n, c, dtype, want):
    x, scale, bias = _group_norm_args(np.random.RandomState(n), 2, n, c, dtype)
    path = group_norm_path(2, n, c, dtype)
    assert path[0] == want
    if want == "cluster":  # the card places such a cluster
        assert _build.load_library().fyc_group_norm_max_clusters(
            c, path[1], path[2], _build.DTYPE_CODES[dtype]) >= 1
    before = fused_group_norm.launches
    got = fused_group_norm(x, scale, bias, 32, 1e-6, None)
    assert fused_group_norm.launches == before + 1
    assert_close(got, group_norm_ref(x, scale, bias, 32, 1e-6, None),
                 FP32_REL if dtype == F32 else BF16_REL)


def test_unrouted_wrappers_reject_what_the_kernels_do_not_take(card):
    rs = np.random.RandomState(0)
    args = cross_args(rs, 1, 16, 1280, 77, F32)
    with pytest.raises(ValueError):                     # fp32 at 1280 does
        fused_ln_cross_attention(*args, heads=8)        # not fit on chip
    long = cross_args(rs, 1, 16, 64, 129, BF16)
    with pytest.raises(ValueError):
        fused_ln_cross_attention(*long, heads=4)        # Skv > 128
    x = _randn(rs, (2, 16, 36))
    with pytest.raises(ValueError):                     # C % 8 != 0
        fused_group_norm(x, x[0, 0], x[0, 0], groups=4)
    with pytest.raises(TypeError):                      # no fp16 kernel
        fused_group_norm(x[..., :32].half().contiguous(),
                         *[torch.ones(32, device="cuda").half()] * 2,
                         groups=8)


@pytest.mark.parametrize("plus,schedule", [(False, None), (True, None),
                                           (False, "pab244_deep4_cfg4_ex")])
def test_tiny_ip_request_card_against_cpu(card, plus, schedule):
    """A tiny fp32 IP-Adapter request (vanilla or Plus) on the card against
    the same request on the CPU: 2e-3 on the [0, 1] video, as
    chip_smoke.py's tiny phase."""
    import chip_smoke
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )

    cpu, gpu = chip_smoke.tiny_pipelines(chip_smoke.tiny_config(), 2, plus)
    spec = SampleSpec(video_length=4, height=64, width=64,
                      num_inference_steps=2 if schedule is None else 6)
    if schedule is not None:
        spec = apply_schedule(spec, schedule)
    with torch.inference_mode():
        req = chip_smoke.make_request(cpu, spec, 3, 1000)
    assert "ip_pixel_values" in req
    want = cpu.sample(spec=spec, **req)
    got = gpu.sample(spec=spec, **req)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, 4, 64, 64, 3)
    assert float((got.cpu() - want).abs().max()) <= chip_smoke.TINY_VIDEO_ATOL


# flash attention over twice the keys (cross-frame self-attention: frame 0
# and the frame before each query frame), up to the level-0 shape of one
# clip at 512² after the CFG duplication (32 rows, 4096 queries, 8192 keys)
@pytest.mark.parametrize("b,sq,h,d,dtypes", [
    (2, 300, 4, 40, (F32, BF16)), (4, 1024, 8, 40, (F32, BF16)),
    (32, 4096, 8, 40, (BF16,))])
def test_flash_attention_at_twice_the_keys(card, b, sq, h, d, dtypes):
    rs = np.random.RandomState(sq)
    for dtype in dtypes:
        q = _randn(rs, (b, sq, h, d), 1.0, dtype)
        k, v = (_randn(rs, (b, 2 * sq, h, d), 1.0, dtype) for _ in range(2))
        before = flash_attention.launches
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert_close(got, flash_attention_ref(q, k, v),
                     FP32_REL if dtype == F32 else BF16_REL)


@pytest.mark.parametrize("q_shape,k_shape,kernel", [
    # the level-0 cross-frame shape of one clip: the flash route
    ((32, 4096, 8, 40), (32, 8192, 8, 40), "flash"),
    # a motion / in-block temporal attention shape: the tiny route
    ((512, 16, 8, 40), (512, 16, 8, 40), "tiny")], ids=["flash", "tiny"])
def test_upcast_attention_runs_the_fp32_kernel(card, q_shape, k_shape,
                                               kernel):
    """``upcast_attention``: q and k in fp32, v in bf16. The dispatch casts
    v up and launches the route's kernel in fp32, as the JAX plain path
    computes fp32 weights times v promoted."""
    rs = np.random.RandomState(7)
    q = _randn(rs, q_shape, 1.0, F32)
    k = _randn(rs, k_shape, 1.0, F32)
    v = _randn(rs, k_shape, 1.0, BF16)
    wrapper, ref = ((flash_attention, flash_attention_ref) if kernel == "flash"
                    else (temporal_attention, temporal_attention_ref))
    before = wrapper.launches
    got = dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.dtype == F32
    assert_close(got, ref(q, k, v.float()), FP32_REL)


# the frame attention at the widths of temporal_attention_dim_div = 2
# (D = C / 8 / 2 at C = 320, 640, 1280) and of the in-block temporal
# attention (D = 40, 80, 160), 16 frames
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,d", [(8192, 20), (2048, 40), (512, 80),
                                 (128, 80), (8192, 40), (2048, 80)])
def test_temporal_attention_at_the_dim_div_widths(card, dtype, b, d):
    rs = np.random.RandomState(b + d)
    q, k, v = (_randn(rs, (b, 16, 8, d), 1.0, dtype) for _ in range(3))
    before = temporal_attention.launches
    got = temporal_attention(q, k, v)
    torch.cuda.synchronize()
    assert temporal_attention.launches == before + 1
    assert_close(got, temporal_attention_ref(q, k, v),
                 FP32_REL if dtype == F32 else BF16_REL)


@pytest.mark.parametrize("c,dtype,mm,want", [
    # RoPE or LoRA: the modular path, every attention on the frame kernel
    (320, BF16, dict(use_rope_position_encoding=True), [0, 0, 2, 1]),
    (640, F32, dict(add_temporal_lora=True), [0, 0, 2, 1]),
    # a _Cross block: fused_temporal_block below 1280
    (320, BF16, dict(attention_block_types=("Temporal_Self",
                                            "Temporal_Cross")), [0, 2, 0, 1]),
    (1280, BF16, dict(attention_block_types=("Temporal_Self",
                                             "Temporal_Cross")),
     [0, 0, 2, 1]),
    # dim_div 2: half-width heads on the frame kernel
    (640, BF16, dict(temporal_attention_dim_div=2), [0, 0, 2, 1])])
def test_motion_options_route_on_the_card(card, c, dtype, mm, want):
    """A motion module with each option (64 positions, 16 frames) on the
    card against its plain run on the CPU, with the kernels each route
    launches; the LoRA ``up`` is given weights."""
    torch.manual_seed(c)
    cpu = MotionModule(c, MotionModuleConfig(zero_initialize=False, **mm))
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "up") and isinstance(m.up, torch.nn.Linear):
                m.up.weight.normal_(0.0, 0.1)
    cpu = cpu.to(dtype)
    gpu = copy.deepcopy(cpu).to("cuda")
    x = _randn(np.random.RandomState(c), (1, 16, 8, 8, c), 1.0, dtype, "cpu")
    with torch.no_grad():
        want_out = cpu(x)
        before = _counts()
        got = gpu(x.cuda())
        torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == want
    assert_close(got.cpu(), want_out, FP32_REL if dtype == F32 else BF16_REL)


def test_entry_runs_on_the_card(card):
    """One CFG UNet3D step of the flagship config on the card (bf16)."""
    from followyourclick_tpu_torch.entry import entry

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    assert out.shape == (2, 8, 32, 32, 4) and out.dtype == BF16
    assert bool(torch.isfinite(out).all())
