"""LayerNorm → cross-attention over a short key set → out projection, on
hand-written kernels.

Port of ``followyourclick_tpu/ops/cross_attention.py::
fused_ln_cross_attention``. On a CPU tensor :func:`fused_ln_cross_attention`
runs :func:`ln_cross_attention_ref`, the plain PyTorch version with the
kernel's numerics. On a CUDA tensor it launches the kernels of
``csrc/cross_attention.cu`` or raises:

- bf16: four launches, one per stage, whose plain versions compose to
  :func:`ln_cross_attention_ref` bit for bit: (a) ``geglu.ln_rows_bf16``
  (:func:`geglu.layer_norm_cast`), (b) :func:`linear_bf16`, ``q = xn·Wqᵀ``
  on the GEMM core (:func:`q_stage`), (c) :func:`attention_bf16`, the
  short-kv attention per batch row and head (:func:`attention_stage`), (d)
  ``geglu.down_bf16`` without the residual, ``o·Woᵀ + bo``
  (:func:`geglu.down_stage`). ``xn`` and then ``o`` share one buffer with
  ``q`` beside it.
- fp32: one launch of the all-on-chip kernel.

Nothing else routes between them: the dtype alone chooses. Each wrapper
call counts one launch, whatever the number of device kernels. k and v are
projected outside the kernels in the working dtype (``F.linear``), as the
JAX wrapper leaves them to XLA.

Weights are in ``nn.Linear`` layout: ``wq (H·D, C)``, ``wk, wv (H·D, Ck)``,
``wo (C, H·D)`` (the transposes of the JAX kernel's). Numerics (as the
Pallas ``_kernel``): LN statistics in fp32, the LN output cast; q
accumulated in fp32 and cast; the logits in fp32 times ``scale``, the
softmax in fp32, the weights cast; ``p·v`` accumulated in fp32 and cast;
``o·Woᵀ + bo`` in fp32 and cast. The result is pre-residual.

Not routed, as in the JAX package, which has no caller of the kernel.
Under autograd the call goes through :class:`LnCrossAttentionGrad`
(``ops/autograd.Recompute``): the kernels forward, and the gradients of
:func:`ln_cross_attention_fp32`, as the JAX ``_ln_cross_attn_bwd`` takes
them.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.autograd import Recompute, needs_grad
from followyourclick_tpu_torch.ops.geglu import (
    down_bf16,
    layer_norm_cast,
    linear_f32,
    ln_rows_bf16,
)

MAX_KV = 128  # the JAX kernel's key-segment width (_KV_SEG)


def project_kv(context: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor):
    """k, v ``(B, Skv, H·D)`` in the working dtype."""
    return F.linear(context, wk), F.linear(context, wv)


def ln_cross_attention_ref(x, context, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                           heads: int, scale: float | None = None,
                           eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``(B, S, C)`` rows and
    ``(B, Skv, Ck)`` context in, ``(B, S, C)`` out, pre-residual."""
    b, s, _ = x.shape
    d = wq.shape[0] // heads
    if scale is None:
        scale = d ** -0.5
    dt = x.dtype
    k, v = project_kv(context, wk, wv)
    q = linear_f32(layer_norm_cast(x, ln_scale, ln_bias, eps), wq).to(dt)
    q = q.reshape(b, s, heads, d).transpose(1, 2).float()
    k = k.reshape(b, -1, heads, d).transpose(1, 2).float()
    v = v.reshape(b, -1, heads, d).transpose(1, 2)
    w = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1).to(dt)
    o = (w.float() @ v.float()).to(dt).transpose(1, 2).reshape(b, s, -1)
    return linear_f32(o, wo, bo).to(dt)


def ln_cross_attention_fp32(x, context, ln_scale, ln_bias, wq, wk, wv, wo,
                            bo, *, heads: int, scale: float,
                            eps: float) -> torch.Tensor:
    """LN → cross-attention → out projection in fp32 (JAX ``_ref_fp32``),
    the reference of the backward."""
    b, s, _ = x.shape
    d = wq.shape[0] // heads
    xf = x.float()
    xn = F.layer_norm(xf, xf.shape[-1:], ln_scale.float(), ln_bias.float(),
                      eps)
    q = F.linear(xn, wq.float()).reshape(b, s, heads, d).transpose(1, 2)
    k, v = (F.linear(context.float(), w.float()).reshape(
        b, -1, heads, d).transpose(1, 2) for w in (wk, wv))
    w = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = (w @ v).transpose(1, 2).reshape(b, s, heads * d)
    return F.linear(o, wo.float(), bo.float())


class LnCrossAttentionGrad(Recompute):
    """:func:`fused_ln_cross_attention` under autograd."""


def q_stage(xn: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Stage (b): ``q = xn·Wqᵀ`` accumulated in fp32, cast to
    ``xn.dtype``."""
    return F.linear(xn, wq)


def attention_stage(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """Stage (c): per batch row and head, softmax attention of ``(B, S,
    H·D)`` q over the ``(B, Skv, H·D)`` k and v; o ``(B, S, H·D)`` in q's
    dtype (fp32 logits and softmax, the weights cast, ``p·v`` in fp32)."""
    b, s, ci = q.shape
    d = ci // heads
    dt = q.dtype
    q = q.reshape(b, s, heads, d).transpose(1, 2).float()
    k = k.reshape(b, -1, heads, d).transpose(1, 2).float()
    v = v.reshape(b, -1, heads, d).transpose(1, 2)
    w = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1).to(dt)
    return (w.float() @ v.float()).to(dt).transpose(1, 2).reshape(b, s, -1)


# One device launch of a bf16 stage each, on row-major CUDA tensors, into a
# buffer the caller allocates; the plain version of each is named in its
# docstring.

def linear_bf16(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """Stage (b), :func:`q_stage`: ``out (R, N)`` from ``a (R, K)`` and
    ``w (N, K)`` on the GEMM core."""
    r, k = a.shape
    _build.check(_build.load_library().fyc_linear_bf16(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), r, w.shape[0], k,
        _build.stream(a)), "q product (fyc_linear_bf16)")


def attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, heads: int, scale: float) -> None:
    """Stage (c), :func:`attention_stage`: ``out (B, S, H·D)`` from ``q (B,
    S, H·D)`` and ``k, v (B, Skv, H·D)``."""
    b, s, ci = q.shape
    _build.check(_build.load_library().fyc_cross_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
        k.shape[1], heads, ci // heads, float(scale), _build.stream(q)),
        "short-kv attention (fyc_cross_attention_bf16)")


def attention_smem(d: int, skv: int) -> int:
    """Shared memory of the attention kernel's smallest tile (one head, 16
    query rows; ``ca_tile_bytes``): q, k and v rows of ``round16(D) + 8``
    bf16, Skv rounded up to 16."""
    r16 = lambda v: -(-v // 16) * 16  # noqa: E731
    return (16 + 2 * r16(skv)) * (r16(d) + 8) * 2


@functools.lru_cache(maxsize=None)
def rows_per_block(c: int, heads: int, d: int, skv: int,
                   dtype: torch.dtype) -> int:
    """Query rows per block of the fp32 kernel: the most (of 64, 32, 16)
    whose tile fits the soft budget, else 16 if that fits the shared memory
    at all, else 0."""
    lib = _build.load_library()
    code = _build.DTYPE_CODES[dtype]

    def smem(rows):
        return lib.fyc_ln_cross_attention_smem_bytes(rows, c, heads, d, skv,
                                                     code)

    for rows in (64, 32, 16):
        if smem(rows) <= _build.SMEM_BUDGET:
            return rows
    return 16 if smem(16) <= _build.MAX_SMEM else 0


def _check(x, k, params, heads) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_ln_cross_attention: dtype {x.dtype} not "
                        "supported")
    if x.ndim != 3 or k.ndim != 3 or k.shape[0] != x.shape[0]:
        raise ValueError("fused_ln_cross_attention: x must be (B, S, C) and "
                         f"context (B, Skv, Ck); got {tuple(x.shape)}, "
                         f"{tuple(k.shape)}")
    b, s, c = x.shape
    ci = k.shape[-1]
    if ci % heads or min(b, s, c) == 0 or b > 65535:
        raise ValueError(f"fused_ln_cross_attention: shape {tuple(x.shape)} "
                         f"with {heads} heads of {ci} channels")
    ls, lb, wq, wo, bo = params
    shapes = {"ln_scale": (ls, (c,)), "ln_bias": (lb, (c,)),
              "wq": (wq, (ci, c)), "wo": (wo, (c, ci)), "bo": (bo, (c,))}
    for name, (t, shape) in shapes.items():
        if t.shape != shape:
            raise ValueError(f"fused_ln_cross_attention: {name} "
                             f"{tuple(t.shape)}, expected {shape}")
    dev = x.get_device()
    for t in (x, *params):
        if t.get_device() != dev or t.dtype != x.dtype:
            raise ValueError("fused_ln_cross_attention: all tensors must "
                             f"share x's device and dtype ({x.device}, "
                             f"{x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_ln_cross_attention: tensors must be "
                             "contiguous")


def _check_bf16(x, k, params, heads) -> None:
    """What the four bf16 launches take beyond ``_check``."""
    b, s, c = x.shape
    ci = k.shape[-1]
    if c % 8 or ci % 8:
        raise ValueError(f"fused_ln_cross_attention: bf16 takes C and H·D "
                         f"multiples of 8 (16-byte rows for TMA), got C={c}, "
                         f"H·D={ci}")
    if any(t.data_ptr() % 16 for t in (x, *params)):
        raise ValueError("fused_ln_cross_attention: data must be 16-byte "
                         "aligned")
    if b * s >= 2 ** 31:
        raise ValueError(f"fused_ln_cross_attention: {b * s} rows are more "
                         "than the kernels index")
    if attention_smem(ci // heads, k.shape[1]) > _build.MAX_SMEM:
        raise ValueError(f"fused_ln_cross_attention: heads of {ci // heads} "
                         f"over {k.shape[1]} keys do not fit one block's "
                         "shared memory")


def _cross_bf16(x, k, v, ln_scale, ln_bias, wq, wo, bo, heads, scale, eps):
    """The four launches of the bf16 call. One buffer holds the LN output,
    then (once q exists) the attention output, and q beside it."""
    b, s, c = x.shape
    r, ci = b * s, wq.shape[0]
    buf = torch.empty(r * (max(c, ci) + ci), dtype=x.dtype, device=x.device)
    xn, o = buf[:r * c].view(r, c), buf[:r * ci].view(b, s, ci)
    q = buf[r * max(c, ci):].view(b, s, ci)
    ln_rows_bf16(x.view(r, c), ln_scale, ln_bias, xn, eps)  # (a)
    linear_bf16(xn, wq, q.view(r, ci))                      # (b)
    attention_bf16(q, k, v, o, heads, scale)                # (c)
    out = torch.empty_like(x)
    down_bf16(o.view(r, ci), wo, bo, None, out.view(r, c))  # (d)
    return out


def fused_ln_cross_attention(x: torch.Tensor, context: torch.Tensor,
                             ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                             wq: torch.Tensor, wk: torch.Tensor,
                             wv: torch.Tensor, wo: torch.Tensor,
                             bo: torch.Tensor, heads: int,
                             scale: float | None = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """LN → cross-attention over ≤ 128 keys → out projection over ``(B,
    S, C)`` rows and ``(B, Skv, Ck)`` context; returns the pre-residual
    output."""
    if context.shape[1] > MAX_KV:
        raise ValueError(f"short-kv kernel requires Skv <= {MAX_KV}, got "
                         f"{context.shape[1]}")
    if scale is None:
        scale = (wq.shape[0] // heads) ** -0.5
    args = (x, context, ln_scale, ln_bias, wq, wk, wv, wo, bo)
    kw = dict(heads=heads, scale=scale, eps=eps)
    run = functools.partial(_ln_cross_attention, **kw)
    if needs_grad(*args):
        return LnCrossAttentionGrad.apply(
            run, functools.partial(ln_cross_attention_fp32, **kw), *args)
    return run(*args)


def _ln_cross_attention(x, context, ln_scale, ln_bias, wq, wk, wv, wo, bo, *,
                        heads, scale, eps):
    """The route: the plain version on a CPU tensor, else the kernels."""
    if x.device.type == "cpu":
        return ln_cross_attention_ref(x, context, ln_scale, ln_bias, wq, wk,
                                      wv, wo, bo, heads, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_cross_attention: no kernel for "
                         f"{x.device}")
    d = wq.shape[0] // heads
    if context.get_device() != x.get_device() or context.dtype != x.dtype:
        raise ValueError("fused_ln_cross_attention: context must share x's "
                         "device and dtype")
    k, v = (t.contiguous() for t in project_kv(context, wk, wv))
    params = (ln_scale, ln_bias, wq, wo, bo)
    _check(x, k, params, heads)
    b, s, c = x.shape
    skv = k.shape[1]
    with _build.on_device(x):
        if x.dtype == torch.bfloat16:
            _check_bf16(x, k, params, heads)
            out = _cross_bf16(x, k, v, *params, heads, scale, eps)
        else:
            rows = rows_per_block(c, heads, d, skv, x.dtype)
            if rows == 0:
                raise ValueError(f"fused_ln_cross_attention: C={c}, {heads} "
                                 f"heads of {d}, {skv} keys in {x.dtype} do "
                                 "not fit one block's shared memory")
            out = torch.empty_like(x)
            _build.check(_build.load_library().fyc_ln_cross_attention(
                x.data_ptr(), k.data_ptr(), v.data_ptr(), ln_scale.data_ptr(),
                ln_bias.data_ptr(), wq.data_ptr(), wo.data_ptr(),
                bo.data_ptr(), out.data_ptr(), b, s, c, heads, d, skv,
                float(scale), float(eps), _build.DTYPE_CODES[x.dtype], rows,
                _build.stream(x)), "fused_ln_cross_attention")
    fused_ln_cross_attention.launches += 1
    return out


fused_ln_cross_attention.launches = 0
