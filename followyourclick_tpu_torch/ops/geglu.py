"""LayerNorm → GEGLU feed-forward → +residual, one hand-written kernel.

Port of ``followyourclick_tpu/ops/geglu.py::fused_ln_geglu``. On a CUDA
tensor ``fused_ln_geglu`` launches the ``sm_90a`` kernel of
``csrc/geglu.cu``; on a CPU tensor it runs :func:`ln_geglu_ref`, the plain
PyTorch version with the same numerics. Nothing else routes between them.

Weights are in ``nn.Linear`` layout: ``w1 (2·inner, C)``, ``w2 (C, inner)``
(the transposes of the JAX kernel's ``(C, 2·inner)`` and ``(inner, C)``).

Numerics (as the Pallas kernel): LN statistics in fp32, the LN output cast
to the working dtype, products accumulated in fp32, bias adds in fp32, the
gate rounded to the working dtype, the residual added in the working dtype.
The gate has two forms (``_gate_mul``): exact erf-GELU in fp32, or tanh-GELU
with every elementwise op in bf16. The tanh form is the default for bf16 at
C ≤ 640; ``FYC_EXACT_GELU=1`` forces the exact one.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build


def default_fast_gating(x: torch.Tensor) -> bool:
    """bf16 tanh gating at C ≤ 640, unless ``FYC_EXACT_GELU`` is set."""
    if os.environ.get("FYC_EXACT_GELU", "") not in ("", "0"):
        return False
    return x.dtype == torch.bfloat16 and x.shape[-1] <= 640


def gate_mul(h: torch.Tensor, gate: torch.Tensor, fast: bool,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``h * gelu(gate)`` from fp32 ``h``/``gate``, in ``out_dtype``."""
    if not fast:
        return (h * F.gelu(gate, approximate="none")).to(out_dtype)
    bf = torch.bfloat16
    gb, hb = gate.to(bf), h.to(bf)
    c1 = torch.tensor(0.044715, dtype=bf, device=gb.device)
    c2 = torch.tensor(0.7978845608, dtype=bf, device=gb.device)
    inner = c2 * (gb + c1 * gb * gb * gb)
    g = 0.5 * gb * (1.0 + torch.tanh(inner))
    return (hb * g).to(out_dtype)


def linear_f32(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """``x · wᵀ (+ b)`` in the working dtype, returned in fp32 with the bias
    added in fp32."""
    y = F.linear(x, w).float()
    return y if b is None else y + b.float()


def layer_norm_cast(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LN with fp32 statistics, output cast to ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    ctr = xf - mean
    var = (ctr * ctr).mean(-1, keepdim=True)
    n = ctr * torch.rsqrt(var + eps)
    return (n * scale.float() + bias.float()).to(x.dtype)


def geglu_ff(t: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, fast: bool) -> torch.Tensor:
    """``gate(t · W1 + b1) · W2 + b2`` in fp32 (t in the working dtype)."""
    inner = w2.shape[1]
    h2 = linear_f32(t, w1, b1)
    y = gate_mul(h2[..., :inner], h2[..., inner:], fast, t.dtype)
    return linear_f32(y, w2, b2)


def ln_geglu_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5,
                 residual: bool = True, fast_gating: bool = False):
    """The plain PyTorch version of the kernel, with the kernel's numerics."""
    t = layer_norm_cast(x, ln_scale, ln_bias, eps)
    out = geglu_ff(t, w1, b1, w2, b2, fast_gating).to(x.dtype)
    return out + x if residual else out


@functools.lru_cache(maxsize=None)
def rows_per_block(c: int, dtype: torch.dtype) -> int:
    """Rows per block: the most (of 64, 32, 16) whose tile fits the budget."""
    lib = _build.load_library()
    code = _build.DTYPE_CODES[dtype]
    for rows in (64, 32, 16):
        if lib.fyc_ln_geglu_smem_bytes(rows, c, code) <= _build.SMEM_BUDGET:
            return rows
    return 16


def _check(x, params) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_ln_geglu: dtype {x.dtype} not supported")
    if x.ndim != 2:
        raise ValueError(f"fused_ln_geglu: x must be (R, C), got {x.shape}")
    r, c = x.shape
    ls, lb, w1, b1, w2, b2 = params
    inner = w2.shape[1]
    shapes = {"ln_scale": (ls, (c,)), "ln_bias": (lb, (c,)),
              "w1": (w1, (2 * inner, c)), "b1": (b1, (2 * inner,)),
              "w2": (w2, (c, inner)), "b2": (b2, (c,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_ln_geglu: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    for t in (x,) + tuple(params):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("fused_ln_geglu: all tensors must share x's "
                             f"device and dtype ({x.device}, {x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_ln_geglu: tensors must be contiguous")
    if r == 0 or r >= 2 ** 31 // max(c, 1):
        raise ValueError(f"fused_ln_geglu: unsupported row count {r}")


def fused_ln_geglu(x: torch.Tensor, ln_scale: torch.Tensor,
                   ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                   residual: bool = True,
                   fast_gating: bool | None = None) -> torch.Tensor:
    """LN → GEGLU FF → (+x) over ``(R, C)`` rows; one read, one write."""
    if fast_gating is None:
        fast_gating = default_fast_gating(x)
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ln_geglu_ref(x, *params, eps=eps, residual=residual,
                            fast_gating=fast_gating)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_geglu: no kernel for {x.device}")
    _check(x, params)
    r, c = x.shape
    lib = _build.load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.fyc_ln_geglu(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), r, c, w2.shape[1], float(eps), int(residual),
            int(fast_gating), _build.DTYPE_CODES[x.dtype],
            rows_per_block(c, x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_ln_geglu")
    fused_ln_geglu.launches += 1
    return out


fused_ln_geglu.launches = 0
