"""LayerNorm → cross-attention over a short key set → out projection, one
hand-written kernel.

Port of ``followyourclick_tpu/ops/cross_attention.py::
fused_ln_cross_attention``. On a CUDA tensor
:func:`fused_ln_cross_attention` launches the ``sm_90a`` kernel of
``csrc/cross_attention.cu`` or raises; on a CPU tensor it runs
:func:`ln_cross_attention_ref`, the plain PyTorch version with the kernel's
numerics. k and v are projected outside the kernel in the working dtype
(``F.linear``), as the JAX wrapper leaves them to XLA.

Weights are in ``nn.Linear`` layout: ``wq (H·D, C)``, ``wk, wv (H·D, Ck)``,
``wo (C, H·D)`` (the transposes of the JAX kernel's). Numerics (as the
Pallas ``_kernel``): LN statistics in fp32, the LN output cast; q
accumulated in fp32 and cast; the logits in fp32 times ``scale``, the
softmax in fp32, the weights cast; ``p·v`` accumulated in fp32 and cast;
``o·Woᵀ + bo`` in fp32 and cast. The result is pre-residual.

Not routed, as in the JAX package, which has no caller of the kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.geglu import layer_norm_cast, linear_f32

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


@functools.lru_cache(maxsize=None)
def rows_per_block(c: int, heads: int, d: int, skv: int,
                   dtype: torch.dtype) -> int:
    """Query rows per block: the most (of 64, 32, 16) whose tile fits the
    soft budget, else 16 if that fits the shared memory at all, else 0."""
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
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_ln_cross_attention: {name} "
                             f"{tuple(t.shape)}, expected {shape}")
    for t in (x, *params):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("fused_ln_cross_attention: all tensors must "
                             f"share x's device and dtype ({x.device}, "
                             f"{x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_ln_cross_attention: tensors must be "
                             "contiguous")


def fused_ln_cross_attention(x: torch.Tensor, context: torch.Tensor,
                             ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                             wq: torch.Tensor, wk: torch.Tensor,
                             wv: torch.Tensor, wo: torch.Tensor,
                             bo: torch.Tensor, heads: int,
                             scale: float | None = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """LN → cross-attention over ≤ 128 keys → out projection, one read of
    ``x`` and one write; returns the pre-residual output."""
    if context.shape[1] > MAX_KV:
        raise ValueError(f"short-kv kernel requires Skv <= {MAX_KV}, got "
                         f"{context.shape[1]}")
    d = wq.shape[0] // heads
    if scale is None:
        scale = d ** -0.5
    if x.device.type == "cpu":
        return ln_cross_attention_ref(x, context, ln_scale, ln_bias, wq, wk,
                                      wv, wo, bo, heads, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_cross_attention: no kernel for "
                         f"{x.device}")
    if context.device != x.device or context.dtype != x.dtype:
        raise ValueError("fused_ln_cross_attention: context must share x's "
                         "device and dtype")
    k, v = (t.contiguous() for t in project_kv(context, wk, wv))
    params = (ln_scale, ln_bias, wq, wo, bo)
    _check(x, k, params, heads)
    b, s, c = x.shape
    skv = k.shape[1]
    rows = rows_per_block(c, heads, d, skv, x.dtype)
    if rows == 0:
        raise ValueError(f"fused_ln_cross_attention: C={c}, {heads} heads of "
                         f"{d}, {skv} keys in {x.dtype} do not fit one "
                         "block's shared memory")
    lib = _build.load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.fyc_ln_cross_attention(
            x.data_ptr(), k.data_ptr(), v.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), wq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), b, s, c, heads, d, skv, float(scale), float(eps),
            _build.DTYPE_CODES[x.dtype], rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_ln_cross_attention")
    fused_ln_cross_attention.launches += 1
    return out


fused_ln_cross_attention.launches = 0
