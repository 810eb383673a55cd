"""The motion-module transformer block on hand-written kernels.

Port of ``followyourclick_tpu/ops/motion_block.py::fused_motion_block``: over
frames-minor rows ``(P, F, C)``, twice [LN → +PE → q/k/v → per-head softmax
over the F frames → out-proj + bias → +residual], then LN → GEGLU FF →
+residual. On a CPU tensor it runs :func:`motion_block_ref`, the plain
PyTorch version with the same numerics. On a CUDA tensor:

- bf16 (every path of the sampler): eleven launches per call, one for each
  stage, whose plain versions compose to :func:`motion_block_ref` bit for
  bit. Per attention sublayer: (a) :func:`ln_pe_stage`, the LN pass of
  ``csrc/geglu.cu`` with the PE table; (b) :func:`qkv_stage`, one product on
  the GEMM core (``csrc/gemm.cuh``) over the concatenated ``[Wq; Wk; Wv]``
  (``csrc/motion_block.cu``); (c) :func:`attention_stage`, the frame
  attention of ``csrc/temporal_attention.cu``; (d) ``ops/geglu.down_stage``
  with the residual, the down-projection of ``csrc/geglu.cu`` on ``Wo``.
  Then the feed-forward's three launches of ``csrc/geglu.cu``
  (``layer_norm_cast``, ``up_stage``, ``down_stage`` with the residual).
  The wrapper allocates the intermediates from PyTorch's caching allocator:
  three ``(R, C)`` buffers (the LN output, later o; the two residual
  streams, which alternate so that no launch writes the h it reads) and one
  ``(R, 4C)`` buffer that holds q, k and v, later the FF's gated rows.
- fp32: one launch of the all-on-chip kernel (``csrc/motion_block.cu``
  ``motion_block_kernel``).

Nothing else routes between them: the dtype alone chooses. Each wrapper
call counts one launch, whatever the number of device kernels.

Under autograd (an input that requires grad) the call goes through
:class:`MotionBlockGrad`: it saves ``(x, pe, params)`` and differentiates
:func:`motion_block_fp32`, the JAX ``_block_bwd`` recompute (exact GELU in
either gate form), never the kernel's intermediates. ``qkv`` is a forward
input only: ``Wq``, ``Wk`` and ``Wv`` take their gradients through
``params``.

``params`` is the JAX kernel's 20-tensor tuple ``(l0s, l0b, wq0, wk0, wv0,
wo0, bo0, l1s, l1b, wq1, wk1, wv1, wo1, bo1, lfs, lfb, w1, b1, w2, b2)``
with every matrix in ``nn.Linear`` layout ``(out, in)``. ``qkv``, the two
sublayers' ``[Wq; Wk; Wv]`` of shape ``(3C, C)`` (:func:`qkv_weights`), is
built by the caller once per module; without it the wrapper builds it.
Each call runs in the tracer's span
``fyc.kernel.fused_motion_block:<P>x<F>x<C>x<heads>`` (``utils/profiling``).

Numerics (as the Pallas kernel): LN output cast to the working dtype before
``+pe`` and the products; q, k, v cast after fp32 accumulation; softmax in
fp32 with p cast before p·v; bias adds in fp32; residual adds in the working
dtype; the FF gate as in ``ops/geglu.py`` (same default form).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.autograd import Recompute, needs_grad
from followyourclick_tpu_torch.ops.geglu import (
    default_fast_gating,
    down_bf16,
    down_stage,
    layer_norm_cast,
    ln_rows_bf16,
    up_bf16,
    up_stage,
)
from followyourclick_tpu_torch.ops.temporal_attention import (
    MAX_FRAMES,
    temporal_attention_ref,
)
from followyourclick_tpu_torch.utils.profiling import span


def ln_pe_stage(h: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                pe: torch.Tensor, eps: float) -> torch.Tensor:
    """Stage (a): LN with fp32 statistics cast to ``h.dtype``, then ``+ pe``
    in that dtype (``h`` (..., F, C), ``pe`` (F, C))."""
    return layer_norm_cast(h, ls, lb, eps) + pe


def qkv_stage(t: torch.Tensor, wqkv: torch.Tensor) -> tuple:
    """Stage (b): q, k, v = ``t · Wᵀ`` for the three C-row ranges of
    ``wqkv = [Wq; Wk; Wv]``, accumulated in fp32 and cast to ``t.dtype``."""
    return tuple(F.linear(t, w) for w in wqkv.chunk(3))


def attention_stage(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, heads: int) -> torch.Tensor:
    """Stage (c): per position and head, softmax attention over the F
    frames of ``(P, F, C)`` q, k, v (heads contiguous along C); o in the
    input dtype."""
    p, f, c = q.shape
    q, k, v = (u.reshape(p, f, heads, c // heads) for u in (q, k, v))
    return temporal_attention_ref(q, k, v, scale).reshape(p, f, c)


def qkv_weights(params) -> tuple:
    """The two sublayers' ``[Wq; Wk; Wv]``, each ``(3C, C)``, the operand of
    stage (b)."""
    return tuple(torch.cat(params[7 * i + 2:7 * i + 5]) for i in range(2))


def motion_block_ref(x: torch.Tensor, pe: torch.Tensor, params, scale: float,
                     heads: int, eps: float = 1e-5,
                     fast_gating: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with the kernel's numerics."""
    pe = pe.to(x.dtype)
    h = x
    for i in range(2):
        ls, lb, wq, wk, wv, wo, bo = params[7 * i:7 * i + 7]
        t = ln_pe_stage(h, ls, lb, pe, eps)
        q, k, v = (F.linear(t, w) for w in (wq, wk, wv))
        h = down_stage(attention_stage(q, k, v, scale, heads), wo, bo, h)
    lfs, lfb, w1, b1, w2, b2 = params[14:20]
    y = up_stage(layer_norm_cast(h, lfs, lfb, eps), w1, b1, fast_gating)
    return down_stage(y, w2, b2, h)


def motion_block_fp32(x: torch.Tensor, pe: torch.Tensor, *params,
                      scale: float, heads: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """The block in fp32 with exact GELU (JAX ``_ref_fp32``): the math the
    backward differentiates."""
    x, pe = x.float(), pe.float()
    params = [t.float() for t in params]
    p, f, c = x.shape
    h = x
    for i in range(2):
        ls, lb, wq, wk, wv, wo, bo = params[7 * i:7 * i + 7]
        t = F.layer_norm(h, (c,), ls, lb, eps) + pe
        q, k, v = (F.linear(t, w).reshape(p, f, heads, c // heads)
                   for w in (wq, wk, wv))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        h = h + F.linear(o.reshape(p, f, c), wo, bo)
    lfs, lfb, w1, b1, w2, b2 = params[14:20]
    hv, gate = F.linear(F.layer_norm(h, (c,), lfs, lfb, eps), w1,
                        b1).chunk(2, -1)
    return h + F.linear(hv * F.gelu(gate), w2, b2)


class MotionBlockGrad(Recompute):
    """:func:`fused_motion_block` under autograd."""


@functools.lru_cache(maxsize=None)
def positions_per_block(f: int, c: int) -> int:
    """Positions per block of the fp32 kernel: the most (of 4, 2, 1, with
    G·F ≤ 64 rows) whose tile fits the budget, else 1 if that fits the
    shared memory at all, else 0 (the block does not fit on chip)."""
    lib = _build.load_library()
    return _build.tile_positions(
        f, lambda g: lib.fyc_motion_block_smem_bytes(g, f, c))


def fits(f: int, c: int, heads: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a position of ``f`` frames at width ``c`` in
    ``dtype`` (the model's route test): bf16 at ``f ≤ 32`` frames (the frame
    attention's limit) and C a multiple of 8 (16-byte rows for TMA); fp32
    where one block of the all-on-chip kernel holds a position, which at 16
    frames is C < 640."""
    if dtype == torch.bfloat16:
        return f <= MAX_FRAMES and c % 8 == 0
    if dtype == torch.float32:
        return positions_per_block(f, c) > 0
    return False


def _check(x, pe, params, qkv, heads) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_motion_block: dtype {x.dtype} not supported")
    if x.ndim != 3:
        raise ValueError(f"fused_motion_block: x must be (P, F, C), "
                         f"got {tuple(x.shape)}")
    if len(params) != 20:
        raise ValueError(f"fused_motion_block: 20 params, got {len(params)}")
    p, f, c = x.shape
    if c % heads:
        raise ValueError(f"fused_motion_block: C={c} not divisible by "
                         f"{heads} heads")
    if p == 0 or p * f >= 2 ** 31 // (4 * c):
        raise ValueError(f"fused_motion_block: unsupported row count {p * f}")
    vec, mat = (c,), (c, c)
    want = [vec, vec, mat, mat, mat, mat, vec] * 2 + [
        vec, vec, (8 * c, c), (8 * c,), (c, 4 * c), vec]
    for i, (t, shape) in enumerate(zip(params, want)):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_motion_block: params[{i}] "
                             f"{tuple(t.shape)}, expected {shape}")
    if tuple(pe.shape) != (f, c):
        raise ValueError(f"fused_motion_block: pe {tuple(pe.shape)}, "
                         f"expected {(f, c)}")
    if x.dtype == torch.bfloat16 and (
            len(qkv) != 2 or any(tuple(w.shape) != (3 * c, c) for w in qkv)):
        raise ValueError("fused_motion_block: qkv must be two (3C, C) "
                         "weights")
    for t in (x, pe, *params, *qkv):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("fused_motion_block: all tensors must share x's "
                             f"device and dtype ({x.device}, {x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_motion_block: tensors must be contiguous")
    if not fits(f, c, heads, x.dtype):
        raise ValueError(f"fused_motion_block: F={f}, C={c}, {x.dtype} is "
                         "not taken: bf16 needs F <= 32 and C % 8 == 0, fp32 "
                         "one block's shared memory")
    if x.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (x, pe, *params, *qkv)):
        raise ValueError("fused_motion_block: data must be 16-byte aligned")


def qkv_bf16(t: torch.Tensor, wqkv: torch.Tensor, q: torch.Tensor,
             k: torch.Tensor, v: torch.Tensor) -> None:
    """Stage (b) on the card, one launch (:func:`qkv_stage`): q, k, v
    ``(R, C)`` from ``t (R, C)`` and ``wqkv (3C, C)``."""
    r, c = t.shape
    lib = _build.load_library()
    _build.check(lib.fyc_qkv_bf16(
        t.data_ptr(), wqkv.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), r, c, torch.cuda.current_stream(t.device).cuda_stream),
        "q/k/v product (fyc_qkv_bf16)")


def attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, frames: int, heads: int,
                   scale: float) -> None:
    """Stage (c) on the card, one launch of the frame-attention kernel of
    ``csrc/temporal_attention.cu`` (:func:`attention_stage`) over
    ``(R, C)`` rows of ``R / frames`` positions."""
    r, c = q.shape
    lib = _build.load_library()
    _build.check(lib.fyc_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        r // frames, frames, heads, c // heads, float(scale),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream),
        "frame attention (fyc_temporal_attention)")


def _block_bf16(x, pe, params, qkv, scale, heads, eps, fast):
    """The eleven launches of the bf16 block; returns the new h."""
    p, f, c = x.shape
    r = p * f
    t = torch.empty(r, c, dtype=x.dtype, device=x.device)  # (a), then o
    hs = (torch.empty_like(t), torch.empty_like(t))
    y = torch.empty(r, 4 * c, dtype=x.dtype, device=x.device)
    q, k, v = y.view(-1)[:3 * r * c].view(3, r, c)  # dead before the FF
    h = x.view(r, c)
    for i in range(2):
        ls, lb, _, _, _, wo, bo = params[7 * i:7 * i + 7]
        ln_rows_bf16(h, ls, lb, t, eps, pe)                   # (a)
        qkv_bf16(t, qkv[i], q, k, v)                          # (b)
        attention_bf16(q, k, v, t, f, heads, scale)           # (c)
        down_bf16(t, wo, bo, h, hs[i])                        # (d)
        h = hs[i]
    lfs, lfb, w1, b1, w2, b2 = params[14:20]
    ln_rows_bf16(h, lfs, lfb, t, eps)
    up_bf16(t, w1, b1, y, fast)
    out = hs[0]  # the first sublayer's h: nothing reads it any more
    down_bf16(y, w2, b2, h, out)
    return out.view(p, f, c)


def fused_motion_block(x: torch.Tensor, pe: torch.Tensor, params,
                       scale: float, heads: int, eps: float = 1e-5,
                       fast_gating: bool | None = None,
                       qkv: tuple | None = None) -> torch.Tensor:
    """LN→attn→res → LN→attn→res → LN→GEGLU-FF→res over ``(P, F, C)``."""
    if fast_gating is None:
        fast_gating = default_fast_gating(x)
    params = tuple(params)
    run = functools.partial(_motion_block, scale=scale, heads=heads, eps=eps,
                            fast=fast_gating, qkv=qkv)
    with span("fyc.kernel.fused_motion_block", *x.shape, heads):
        if needs_grad(x, pe, *params):
            return MotionBlockGrad.apply(
                run, functools.partial(motion_block_fp32, scale=scale,
                                       heads=heads, eps=eps), x, pe, *params)
        return run(x, pe, *params)


def _motion_block(x, pe, *params, scale, heads, eps, fast, qkv):
    """The route: the plain version on a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return motion_block_ref(x, pe, params, scale, heads, eps, fast)
    if x.device.type != "cuda":
        raise ValueError(f"fused_motion_block: no kernel for {x.device}")
    pe = pe.to(x.dtype).contiguous()
    if x.dtype != torch.bfloat16:
        qkv = ()  # the fp32 kernel reads Wq, Wk, Wv from params
    elif qkv is None:
        qkv = qkv_weights(params)
    _check(x, pe, params, tuple(qkv), heads)
    p, f, c = x.shape
    with torch.cuda.device(x.device):
        if qkv:
            out = _block_bf16(x, pe, params, qkv, scale, heads, eps, fast)
        else:
            out = torch.empty_like(x)
            ptrs = (ctypes.c_void_p * 20)(*[t.data_ptr() for t in params])
            _build.check(_build.load_library().fyc_motion_block(
                x.data_ptr(), pe.data_ptr(), ptrs, out.data_ptr(), p, f, c,
                heads, positions_per_block(f, c), float(scale), float(eps),
                int(fast), torch.cuda.current_stream(x.device).cuda_stream),
                "fused_motion_block")
    fused_motion_block.launches += 1
    return out


fused_motion_block.launches = 0
