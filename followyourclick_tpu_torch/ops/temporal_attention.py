"""Frame-axis attention on hand-written kernels.

Port of ``followyourclick_tpu/ops/temporal_attention.py``:

- :func:`temporal_attention`: per-head softmax attention over ``S ≤ 32``
  frames on ``(B, S, H, D)`` tensors, the tiny-sequence route of
  ``ops/attention.dot_product_attention`` (the motion module's attention at
  C = 1280, and spatial self-attention of ≤ 32 tokens). One launch of the
  frame-attention kernel of ``csrc/temporal_attention.cu``: a block loads
  one position's rows over a run of whole heads with 16-byte copies, and
  each (position, head) is one warp's; bf16 runs both products on the
  tensor cores (``mma.sync``), fp32 on FMA. The same kernel is stage (c) of
  the bf16 motion block and of the bf16 block below.
- :func:`fused_temporal_block`: the q/k/v projections, that attention and
  the out-projection of one motion-module attention on ``(B, S, C)`` rows
  with the PE already added (C < 1280 on the modular path). On a CUDA
  tensor, bf16 is three launches: (b) ``motion_block.qkv_bf16``, one
  product on the GEMM core over ``qkv = [Wq; Wk; Wv]``; (c) the frame
  attention; (d) ``geglu.down_bf16`` with the bias and no residual. Their
  plain versions (``motion_block.qkv_stage``, ``motion_block
  .attention_stage``, ``geglu.down_stage``) compose to
  :func:`temporal_block_ref` bit for bit. q, k and v go in one ``(3, R,
  C)`` buffer and o in one ``(R, C)`` buffer from PyTorch's caching
  allocator. ``qkv`` (``(3C, C)``) is built by the caller once per module
  (``TemporalAttention.qkv_weight``); without it the wrapper builds it.
  fp32 is one launch of the all-on-chip kernel. Nothing else routes between
  them: the dtype alone chooses.

On a CUDA tensor each wrapper launches or raises; on a CPU tensor it runs
its plain PyTorch version, :func:`temporal_attention_ref` or
:func:`temporal_block_ref`. Each wrapper call counts one launch, whatever
the number of device kernels. Weights are in ``nn.Linear`` layout ``(out,
in)``.

Under autograd (an input that requires grad) a call goes through
:class:`TemporalAttentionGrad` / :class:`TemporalBlockGrad`, which save the
inputs and differentiate :func:`attention_fp32` / :func:`temporal_block_fp32`
(the JAX ``_attn_bwd`` / ``_fused_vjp_bwd`` math: fp32, p never rounded).

Numerics (as the Pallas kernels): logits in fp32 times ``scale``, the softmax
in fp32, p cast to the working dtype before p·v, p·v accumulated in fp32 and
cast; in the block, q, k and v cast after fp32 accumulation, o cast before
the out-projection, whose products accumulate in fp32 with the bias added in
fp32 before the final cast.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.autograd import Recompute, needs_grad
from followyourclick_tpu_torch.ops.geglu import down_bf16, linear_f32

MAX_FRAMES = 32


def temporal_attention_ref(query: torch.Tensor, key: torch.Tensor,
                           value: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of the attention kernel: ``(B, S, H, D)``
    in, ``(B, S, H, D)`` out in the input's dtype."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    p = torch.softmax(s, dim=-1).to(value.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), value.float())
    return o.to(query.dtype)


def temporal_block_ref(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                       scale: float | None = None,
                       heads: int = 8) -> torch.Tensor:
    """The plain PyTorch version of the block: ``(B, S, C)`` in and out, in
    ``x``'s dtype; the products as the motion block's plain version takes
    them (``F.linear`` in the working dtype, the out-projection's bias added
    in fp32 before the cast)."""
    b, s, c = x.shape
    if scale is None:
        scale = (c // heads) ** -0.5
    q, k, v = (F.linear(x, w).reshape(b, s, heads, -1) for w in (wq, wk, wv))
    o = temporal_attention_ref(q, k, v, scale).reshape(b, s, c)
    return linear_f32(o, wo, bo).to(x.dtype)


def attention_fp32(query, key, value, *, scale: float) -> torch.Tensor:
    """Per-head softmax attention in fp32 over ``(B, S, H, D)``: the math
    the backward passes of the frame-axis and flash kernels differentiate."""
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                        value.float())


def temporal_block_fp32(x, wq, wk, wv, wo, bo, *, scale: float,
                        heads: int) -> torch.Tensor:
    """The block in fp32 (JAX ``_fused_ref_fp32``)."""
    b, s, c = x.shape
    xf = x.float()
    q, k, v = (F.linear(xf, w.float()).reshape(b, s, heads, c // heads)
               for w in (wq, wk, wv))
    o = attention_fp32(q, k, v, scale=scale).reshape(b, s, c)
    return F.linear(o, wo.float(), bo.float())


class TemporalAttentionGrad(Recompute):
    """:func:`temporal_attention` under autograd."""


class TemporalBlockGrad(Recompute):
    """:func:`fused_temporal_block` under autograd."""


def _check_dtype_device(name, tensors, like) -> None:
    if like.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {like.dtype} not supported")
    for t in tensors:
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError(f"{name}: all tensors must share the first's "
                             f"device and dtype ({like.device}, {like.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def temporal_attention(query: torch.Tensor, key: torch.Tensor,
                       value: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """Per-head softmax attention over ``S ≤ 32`` on ``(B, S, H, D)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    run = functools.partial(_temporal_attention, scale=scale)
    if needs_grad(query, key, value):
        return TemporalAttentionGrad.apply(
            run, functools.partial(attention_fp32, scale=scale), query, key,
            value)
    return run(query, key, value)


def _temporal_attention(query, key, value, *, scale):
    """The route: the plain version on a CPU tensor, else the kernel."""
    if query.device.type == "cpu":
        return temporal_attention_ref(query, key, value, scale)
    if query.device.type != "cuda":
        raise ValueError(f"temporal_attention: no kernel for {query.device}")
    _check_dtype_device("temporal_attention", (query, key, value), query)
    if query.ndim != 4 or key.shape != query.shape \
            or value.shape != query.shape:
        raise ValueError("temporal_attention: q, k, v must share one "
                         f"(B, S, H, D) shape, got {tuple(query.shape)}, "
                         f"{tuple(key.shape)}, {tuple(value.shape)}")
    b, s, h, d = query.shape
    if not 0 < s <= MAX_FRAMES or b == 0:
        raise ValueError(f"temporal_attention: S={s}, B={b}; the kernel "
                         f"takes 1 ≤ S ≤ {MAX_FRAMES} and B ≥ 1")
    lib = _build.load_library()
    code = _build.DTYPE_CODES[query.dtype]
    if lib.fyc_temporal_attention_smem_bytes(s, d, code) > _build.MAX_SMEM:
        raise ValueError(f"temporal_attention: S={s}, D={d} does not fit one "
                         "block's shared memory")
    out = torch.empty_like(query)
    with torch.cuda.device(query.device):
        err = lib.fyc_temporal_attention(
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            out.data_ptr(), b, s, h, d, float(scale), code,
            torch.cuda.current_stream(query.device).cuda_stream)
    _build.check(err, "temporal_attention")
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0


@functools.lru_cache(maxsize=None)
def positions_per_block(f: int, c: int) -> int:
    """Positions per block of the fp32 :func:`fused_temporal_block` kernel
    (0: no fit)."""
    lib = _build.load_library()
    return _build.tile_positions(
        f, lambda g: lib.fyc_temporal_block_smem_bytes(g, f, c))


def _check_block(x, weights, qkv, heads) -> None:
    b, s, c = x.shape
    _check_dtype_device("fused_temporal_block", (x,) + weights + qkv, x)
    for name, w in zip(("wq", "wk", "wv", "wo"), weights):
        if tuple(w.shape) != (c, c):
            raise ValueError(f"fused_temporal_block: {name} "
                             f"{tuple(w.shape)}, expected {(c, c)}")
    if tuple(weights[4].shape) != (c,):
        raise ValueError(f"fused_temporal_block: bo "
                         f"{tuple(weights[4].shape)}, expected {(c,)}")
    if qkv and tuple(qkv[0].shape) != (3 * c, c):
        raise ValueError(f"fused_temporal_block: qkv {tuple(qkv[0].shape)}, "
                         f"expected {(3 * c, c)}")
    if c % heads or not 0 < s <= MAX_FRAMES or b == 0:
        raise ValueError(f"fused_temporal_block: (B, S, C) = {(b, s, c)} "
                         f"with {heads} heads; the kernel takes 1 ≤ S ≤ "
                         f"{MAX_FRAMES}, B ≥ 1 and C divisible by the heads")
    if x.dtype == torch.bfloat16 and (
            c % 8 or any(t.data_ptr() % 16 for t in (x, *weights, *qkv))):
        raise ValueError(f"fused_temporal_block: bf16 at C={c} is not "
                         "taken: the GEMM core needs C % 8 == 0 (16-byte "
                         "rows) and 16-byte aligned data")
    if x.dtype == torch.bfloat16 and _build.load_library() \
            .fyc_temporal_attention_smem_bytes(s, c // heads, 1) \
            > _build.MAX_SMEM:
        raise ValueError(f"fused_temporal_block: S={s}, head width "
                         f"{c // heads} does not fit one block's shared "
                         "memory")
    if x.dtype == torch.float32 and positions_per_block(s, c) == 0:
        raise ValueError(f"fused_temporal_block: S={s}, C={c}, fp32 does "
                         "not fit one block's shared memory")


def _block_bf16(x, qkv, wo, bo, scale, heads):
    """The three launches of the bf16 block."""
    # motion_block imports this module
    from followyourclick_tpu_torch.ops import motion_block

    b, s, c = x.shape
    r = b * s
    q, k, v = torch.empty(3, r, c, dtype=x.dtype, device=x.device)
    o = torch.empty(r, c, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    motion_block.qkv_bf16(x.view(r, c), qkv, q, k, v)          # (b)
    motion_block.attention_bf16(q, k, v, o, s, heads, scale)   # (c)
    down_bf16(o, wo, bo, None, out.view(r, c))                 # (d)
    return out


def fused_temporal_block(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                         scale: float | None = None, heads: int = 8,
                         qkv: torch.Tensor | None = None) -> torch.Tensor:
    """q/k/v projections → per-head frame attention → out-projection + bias
    over ``(B, S, C)`` rows; ``qkv``: ``[Wq; Wk; Wv]`` for bf16 (a forward
    input only)."""
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    args = (x, wq, wk, wv, wo, bo)
    run = functools.partial(_temporal_block, scale=scale, heads=heads,
                            qkv=qkv)
    if needs_grad(*args):
        return TemporalBlockGrad.apply(
            run, functools.partial(temporal_block_fp32, scale=scale,
                                   heads=heads), *args)
    return run(*args)


def _temporal_block(x, wq, wk, wv, wo, bo, *, scale, heads, qkv):
    """The route: the plain version on a CPU tensor, else the kernel."""
    b, s, c = x.shape
    weights = (wq, wk, wv, wo, bo)
    if x.device.type == "cpu":
        return temporal_block_ref(x, *weights, scale=scale, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block: no kernel for {x.device}")
    bf16 = x.dtype == torch.bfloat16
    _check_block(x, weights, (qkv,) if bf16 and qkv is not None else (),
                 heads)
    with torch.cuda.device(x.device):
        if bf16:
            if qkv is None:
                qkv = torch.cat((wq, wk, wv))
            out = _block_bf16(x, qkv, wo, bo, scale, heads)
        else:
            out = torch.empty_like(x)
            ptrs = (ctypes.c_void_p * 5)(*[w.data_ptr() for w in weights])
            _build.check(_build.load_library().fyc_temporal_block(
                x.data_ptr(), ptrs, out.data_ptr(), b, s, c, heads,
                positions_per_block(s, c), float(scale),
                torch.cuda.current_stream(x.device).cuda_stream),
                "fused_temporal_block")
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0
