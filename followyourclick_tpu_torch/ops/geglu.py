"""LayerNorm → GEGLU feed-forward → +residual, hand-written kernels.

Port of ``followyourclick_tpu/ops/geglu.py``: ``fused_ln_geglu`` and
``fused_geglu`` (the feed-forward alone, no LN and no residual). On a CPU
tensor each runs its plain PyTorch version with the same numerics
(:func:`ln_geglu_ref`, :func:`geglu_ref`). On a CUDA tensor:

- bf16 (every path of the sampler): three launches of ``csrc/geglu.cu``
  per call, one for each stage, whose plain versions are
  :func:`layer_norm_cast` (a: LN with fp32 statistics, cast to bf16),
  :func:`up_stage` (b: ``x·W1ᵀ + b1`` on wgmma, value and gate columns in
  one tile, the gate in the epilogue, ``y`` stored in bf16) and
  :func:`down_stage` (c: ``y·W2ᵀ + b2`` on wgmma, rounded, ``+ x``
  rounded). ``fused_geglu`` is (b) on x and (c) without the residual.
  The wrapper allocates the intermediates ``xn (R, C)`` and
  ``y (R, inner)``.
- fp32: one launch of the all-on-chip kernel (``csrc/geglu.cu``
  ``ln_geglu_kernel``), ``fused_geglu`` in its LN-off, residual-off mode.

Nothing else routes between them: the dtype alone chooses. Each wrapper
call counts one launch, whatever the number of device kernels. As in the
JAX package, no path of the sampler reaches ``fused_geglu``: its caller,
``models/attention.GEGLUFeedForward``, runs on the card only when called
outside ``_ln_ff_residual``.

Under autograd (an input that requires grad) a call goes through
:class:`LnGegluGrad` / :class:`GegluGrad`, which save the inputs and
differentiate :func:`ln_geglu_fp32` / :func:`geglu_fp32` (the JAX
``_ln_geglu_bwd`` / ``_geglu_bwd`` recompute: fp32, exact GELU).

Weights are in ``nn.Linear`` layout: ``w1 (2·inner, C)``, ``w2 (C, inner)``
(the transposes of the JAX kernel's ``(C, 2·inner)`` and ``(inner, C)``).
Each ``fused_ln_geglu`` call runs in the tracer's span
``fyc.kernel.fused_ln_geglu:<R>x<C>`` (``utils/profiling``).

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
from followyourclick_tpu_torch.ops.autograd import Recompute, needs_grad
from followyourclick_tpu_torch.utils.profiling import span


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
    """LN with fp32 statistics, output cast to ``x.dtype`` (stage (a))."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    ctr = xf - mean
    var = (ctr * ctr).mean(-1, keepdim=True)
    n = ctr * torch.rsqrt(var + eps)
    return (n * scale.float() + bias.float()).to(x.dtype)


def up_stage(t: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             fast: bool) -> torch.Tensor:
    """Stage (b): ``h·gelu(gate)`` of ``t·W1ᵀ + b1`` (bias in fp32), in
    ``t.dtype``."""
    inner = w1.shape[0] // 2
    h2 = linear_f32(t, w1, b1)
    return gate_mul(h2[..., :inner], h2[..., inner:], fast, t.dtype)


def down_stage(y: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """Stage (c): ``y·W2ᵀ + b2`` (bias in fp32) cast to ``y.dtype``, then
    ``+ residual`` in that dtype."""
    out = linear_f32(y, w2, b2).to(y.dtype)
    return out if residual is None else out + residual


def geglu_ff(t: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, fast: bool) -> torch.Tensor:
    """``gate(t · W1 + b1) · W2 + b2`` in fp32 (t in the working dtype)."""
    return linear_f32(up_stage(t, w1, b1, fast), w2, b2)


def ln_geglu_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5,
                 residual: bool = True, fast_gating: bool = False):
    """The plain PyTorch version of the kernel, with the kernel's numerics."""
    t = layer_norm_cast(x, ln_scale, ln_bias, eps)
    out = geglu_ff(t, w1, b1, w2, b2, fast_gating).to(x.dtype)
    return out + x if residual else out


def geglu_ref(x, w1, b1, w2, b2, fast_gating: bool = False):
    """The plain PyTorch version of the LN-off mode (the Pallas ``_kernel``):
    ``gate(x · W1 + b1) · W2 + b2``, cast to ``x.dtype``."""
    return geglu_ff(x, w1, b1, w2, b2, fast_gating).to(x.dtype)


def geglu_fp32(x, w1, b1, w2, b2):
    """The feed-forward in fp32 with exact GELU (JAX ``_ref_fp32``)."""
    h, gate = F.linear(x.float(), w1.float(), b1.float()).chunk(2, -1)
    return F.linear(h * F.gelu(gate), w2.float(), b2.float())


def ln_geglu_fp32(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float,
                  residual: bool):
    """LN → feed-forward (→ +x) in fp32 (JAX ``_ln_ref_fp32``)."""
    xf = x.float()
    out = geglu_fp32(F.layer_norm(xf, xf.shape[-1:], ln_scale.float(),
                                  ln_bias.float(), eps), w1, b1, w2, b2)
    return out + xf if residual else out


class LnGegluGrad(Recompute):
    """:func:`fused_ln_geglu` under autograd."""


class GegluGrad(Recompute):
    """:func:`fused_geglu` under autograd."""


@functools.lru_cache(maxsize=None)
def rows_per_block(c: int) -> int:
    """Rows per block of the fp32 kernel: the most (of 64, 32, 16) whose
    tile fits the budget."""
    lib = _build.load_library()
    for rows in (64, 32, 16):
        if lib.fyc_ln_geglu_smem_bytes(rows, c) <= _build.SMEM_BUDGET:
            return rows
    return 16


def _check(what, x, ln_params, ff_params) -> None:
    """Raise on what the kernel does not take; ``ln_params`` is empty in
    the LN-off mode."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be (R, C), got {x.shape}")
    r, c = x.shape
    w1, b1, w2, b2 = ff_params
    inner = w2.shape[1]
    shapes = {"w1": (w1, (2 * inner, c)), "b1": (b1, (2 * inner,)),
              "w2": (w2, (c, inner)), "b2": (b2, (c,))}
    shapes.update(zip(("ln_scale", "ln_bias"),
                      ((t, (c,)) for t in ln_params)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    for t in (x, *ln_params, *ff_params):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{what}: all tensors must share x's "
                             f"device and dtype ({x.device}, {x.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if r == 0 or r >= 2 ** 31 // max(c, inner, 1):
        raise ValueError(f"{what}: unsupported row count {r}")
    if x.dtype == torch.bfloat16:
        # TMA reads rows of 16-byte multiples from 16-byte aligned tensors
        if c % 8 or inner % 8:
            raise ValueError(f"{what}: bf16 takes C and inner multiples of "
                             f"8, got C={c}, inner={inner}")
        if any(t.data_ptr() % 16 for t in (x, *ln_params, *ff_params)):
            raise ValueError(f"{what}: data must be 16-byte aligned")


def _stream(x: torch.Tensor) -> int:
    return _build.stream(x)


# One device launch of a bf16 stage each, on (R, ·) row-major CUDA tensors,
# into a buffer the caller allocates; the plain version of each is named
# in its docstring. The wrappers here and ops/motion_block.py sequence them.

def ln_rows_bf16(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 out: torch.Tensor, eps: float,
                 pe: torch.Tensor | None = None) -> None:
    """Stage (a), :func:`layer_norm_cast` (with ``pe`` (F, C), ``+
    pe[row % F]`` in bf16 after it: the motion block's LN + PE)."""
    r, c = x.shape
    lib = _build.load_library()
    _build.check(lib.fyc_ln_rows_bf16(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if pe is None else pe.data_ptr(), out.data_ptr(), r, c,
        1 if pe is None else pe.shape[0], float(eps), _stream(x)),
        "LN pass (fyc_ln_rows_bf16)")


def up_bf16(t: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            y: torch.Tensor, fast: bool) -> None:
    """Stage (b), :func:`up_stage`: ``y (R, inner)`` from ``t (R, C)``."""
    r, c = t.shape
    lib = _build.load_library()
    _build.check(lib.fyc_geglu_up_bf16(
        t.data_ptr(), w1.data_ptr(), b1.data_ptr(), y.data_ptr(), r, c,
        y.shape[1], int(fast), _stream(t)),
        "up-projection (fyc_geglu_up_bf16)")


def down_bf16(y: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              residual: torch.Tensor | None, out: torch.Tensor) -> None:
    """Stage (c), :func:`down_stage`: ``out (R, C)`` from ``y (R, inner)``;
    ``out`` must not be ``residual`` or ``y``."""
    r, inner = y.shape
    lib = _build.load_library()
    _build.check(lib.fyc_geglu_down_bf16(
        y.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        r, out.shape[1], inner, _stream(y)),
        "down-projection (fyc_geglu_down_bf16)")


def _ff_bf16(x, xn, w1, b1, w2, b2, fast, residual) -> torch.Tensor:
    """Stages (b) and (c) on the card; ``xn`` is the input of (b)."""
    y = torch.empty(x.shape[0], w2.shape[1], dtype=x.dtype, device=x.device)
    up_bf16(xn, w1, b1, y, fast)
    out = torch.empty_like(x)
    down_bf16(y, w2, b2, x if residual else None, out)
    return out


def fused_ln_geglu(x: torch.Tensor, ln_scale: torch.Tensor,
                   ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                   residual: bool = True,
                   fast_gating: bool | None = None) -> torch.Tensor:
    """LN → GEGLU FF → (+x) over ``(R, C)`` rows."""
    if fast_gating is None:
        fast_gating = default_fast_gating(x)
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    run = functools.partial(_ln_geglu, eps=eps, residual=residual,
                            fast=fast_gating)
    with span("fyc.kernel.fused_ln_geglu", *x.shape):
        if needs_grad(*args):
            return LnGegluGrad.apply(
                run, functools.partial(ln_geglu_fp32, eps=eps,
                                       residual=residual), *args)
        return run(*args)


def _ln_geglu(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps, residual, fast):
    """The route: the plain version on a CPU tensor, else the kernel."""
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ln_geglu_ref(x, *params, eps=eps, residual=residual,
                            fast_gating=fast)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_geglu: no kernel for {x.device}")
    _check("fused_ln_geglu", x, params[:2], params[2:])
    r, c = x.shape
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            xn = torch.empty_like(x)
            ln_rows_bf16(x, ln_scale, ln_bias, xn, eps)
            out = _ff_bf16(x, xn, w1, b1, w2, b2, fast, residual)
        else:
            out = torch.empty_like(x)
            lib = _build.load_library()
            _build.check(lib.fyc_ln_geglu(
                x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), r, c, w2.shape[1], float(eps), int(residual),
                int(fast), rows_per_block(c), _stream(x)),
                "fused_ln_geglu")
    fused_ln_geglu.launches += 1
    return out


fused_ln_geglu.launches = 0


def fused_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor,
                fast_gating: bool | None = None) -> torch.Tensor:
    """GEGLU FF over ``(R, C)`` rows: stages (b) and (c) in bf16, the LN-off,
    residual-off mode of the all-on-chip kernel in fp32."""
    if fast_gating is None:
        fast_gating = default_fast_gating(x)
    args = (x, w1, b1, w2, b2)
    run = functools.partial(_geglu, fast=fast_gating)
    if needs_grad(*args):
        return GegluGrad.apply(run, geglu_fp32, *args)
    return run(*args)


def _geglu(x, w1, b1, w2, b2, *, fast):
    """The route: the plain version on a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return geglu_ref(x, w1, b1, w2, b2, fast)
    if x.device.type != "cuda":
        raise ValueError(f"fused_geglu: no kernel for {x.device}")
    _check("fused_geglu", x, (), (w1, b1, w2, b2))
    r, c = x.shape
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            out = _ff_bf16(x, x, w1, b1, w2, b2, fast, residual=False)
        else:
            out = torch.empty_like(x)
            lib = _build.load_library()
            _build.check(lib.fyc_geglu(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), r, c, w2.shape[1],
                int(fast), rows_per_block(c), _stream(x)),
                "fused_geglu")
    fused_geglu.launches += 1
    return out


fused_geglu.launches = 0
