"""The motion-module transformer block in one hand-written kernel.

Port of ``followyourclick_tpu/ops/motion_block.py::fused_motion_block``: over
frames-minor rows ``(P, F, C)``, twice [LN → +PE → q/k/v → per-head softmax
over the F frames → out-proj + bias → +residual], then LN → GEGLU FF →
+residual. On a CUDA tensor it launches the ``sm_90a`` kernel of
``csrc/motion_block.cu``; on a CPU tensor it runs :func:`motion_block_ref`,
the plain PyTorch version with the same numerics.

``params`` is the JAX kernel's 20-tensor tuple ``(l0s, l0b, wq0, wk0, wv0,
wo0, bo0, l1s, l1b, wq1, wk1, wv1, wo1, bo1, lfs, lfb, w1, b1, w2, b2)``
with every matrix in ``nn.Linear`` layout ``(out, in)``.

Numerics (as the Pallas kernel): LN output cast to the working dtype before
``+pe`` and the products; q, k, v cast after fp32 accumulation; softmax in
fp32 with p cast before p·v; bias adds in fp32; residual adds in the working
dtype; the FF gate as in ``ops/geglu.py`` (same default form).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.geglu import (
    default_fast_gating,
    geglu_ff,
    layer_norm_cast,
    linear_f32,
)


def _attention(h, pe, ls, lb, wq, wk, wv, wo, bo, scale, heads, eps):
    b, f, c = h.shape
    d = c // heads
    t = layer_norm_cast(h, ls, lb, eps) + pe
    q = torch.nn.functional.linear(t, wq).reshape(b, f, heads, d)
    k = torch.nn.functional.linear(t, wk).reshape(b, f, heads, d)
    v = torch.nn.functional.linear(t, wv).reshape(b, f, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(h.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, f, c)
    return linear_f32(o, wo, bo).to(h.dtype)


def motion_block_ref(x: torch.Tensor, pe: torch.Tensor, params, scale: float,
                     heads: int, eps: float = 1e-5,
                     fast_gating: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with the kernel's numerics."""
    pe = pe.to(x.dtype)
    h = x
    h = h + _attention(h, pe, *params[0:7], scale, heads, eps)
    h = h + _attention(h, pe, *params[7:14], scale, heads, eps)
    lfs, lfb, w1, b1, w2, b2 = params[14:20]
    t = layer_norm_cast(h, lfs, lfb, eps)
    return h + geglu_ff(t, w1, b1, w2, b2, fast_gating).to(h.dtype)


@functools.lru_cache(maxsize=None)
def positions_per_block(f: int, c: int, heads: int,
                        dtype: torch.dtype) -> int:
    """Positions per block: the most (of 4, 2, 1, with G·F ≤ 64 rows) whose
    tile fits the budget, else 1 if that fits the shared memory at all, else
    0 (the block does not fit on chip; :func:`fits` is the route's test)."""
    if dtype not in _build.DTYPE_CODES:
        return 0
    lib = _build.load_library()
    code = _build.DTYPE_CODES[dtype]
    return _build.tile_positions(
        f, lambda g: lib.fyc_motion_block_smem_bytes(g, f, c, heads, code))


def fits(f: int, c: int, heads: int, dtype: torch.dtype) -> bool:
    """Whether one block of the kernel holds a position of ``f`` frames at
    width ``c`` in ``dtype``: fp32 at C ≥ 640 does not."""
    return positions_per_block(f, c, heads, dtype) > 0


def _check(x, pe, params, heads) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_motion_block: dtype {x.dtype} not supported")
    if x.ndim != 3:
        raise ValueError(f"fused_motion_block: x must be (P, F, C), "
                         f"got {tuple(x.shape)}")
    if len(params) != 20:
        raise ValueError(f"fused_motion_block: 20 params, got {len(params)}")
    _, f, c = x.shape
    if c % heads:
        raise ValueError(f"fused_motion_block: C={c} not divisible by "
                         f"{heads} heads")
    vec, mat = (c,), (c, c)
    want = [vec, vec, mat, mat, mat, mat, vec] * 2 + [
        vec, vec, (8 * c, c), (8 * c,), (c, 4 * c), vec]
    for i, (p, shape) in enumerate(zip(params, want)):
        if tuple(p.shape) != shape:
            raise ValueError(f"fused_motion_block: params[{i}] "
                             f"{tuple(p.shape)}, expected {shape}")
    if tuple(pe.shape) != (f, c):
        raise ValueError(f"fused_motion_block: pe {tuple(pe.shape)}, "
                         f"expected {(f, c)}")
    for t in (x, pe, *params):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("fused_motion_block: all tensors must share x's "
                             f"device and dtype ({x.device}, {x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_motion_block: tensors must be contiguous")


def fused_motion_block(x: torch.Tensor, pe: torch.Tensor, params,
                       scale: float, heads: int, eps: float = 1e-5,
                       fast_gating: bool | None = None) -> torch.Tensor:
    """LN→attn→res → LN→attn→res → LN→GEGLU-FF→res; one read, one write."""
    if fast_gating is None:
        fast_gating = default_fast_gating(x)
    params = tuple(params)
    if x.device.type == "cpu":
        return motion_block_ref(x, pe, params, scale, heads, eps,
                                fast_gating)
    if x.device.type != "cuda":
        raise ValueError(f"fused_motion_block: no kernel for {x.device}")
    pe = pe.to(x.dtype).contiguous()
    _check(x, pe, params, heads)
    p, f, c = x.shape
    g = positions_per_block(f, c, heads, x.dtype)
    if g == 0:
        raise ValueError(f"fused_motion_block: F={f}, C={c}, {x.dtype} does "
                         "not fit one block's shared memory")
    lib = _build.load_library()
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 20)(*[t.data_ptr() for t in params])
    with torch.cuda.device(x.device):
        err = lib.fyc_motion_block(
            x.data_ptr(), pe.data_ptr(), ptrs, out.data_ptr(), p, f, c, heads,
            g, float(scale),
            float(eps), int(fast_gating), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_motion_block")
    fused_motion_block.launches += 1
    return out


fused_motion_block.launches = 0
