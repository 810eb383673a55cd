"""Frame-axis attention in two hand-written kernels.

Port of ``followyourclick_tpu/ops/temporal_attention.py``:

- :func:`temporal_attention`: per-head softmax attention over ``S ≤ 32``
  frames on ``(B, S, H, D)`` tensors, the tiny-sequence route of
  ``ops/attention.dot_product_attention`` (the motion module's attention at
  C = 1280, and spatial self-attention of ≤ 32 tokens);
- :func:`fused_temporal_block`: the q/k/v projections, that attention and
  the out-projection of one motion-module attention on ``(B, S, C)`` rows
  with the PE already added (C < 1280 on the modular path).

On a CUDA tensor each wrapper launches its ``sm_90a`` kernel of
``csrc/temporal_attention.cu`` or raises; on a CPU tensor it runs its plain
PyTorch version, :func:`temporal_attention_ref` or :func:`temporal_block_ref`.
Weights are in ``nn.Linear`` layout ``(out, in)``.

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

from followyourclick_tpu_torch.ops import _build

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
    """The plain PyTorch version of the block kernel: ``(B, S, C)`` in and
    out, in ``x``'s dtype."""
    b, s, c = x.shape
    if scale is None:
        scale = (c // heads) ** -0.5

    def proj(w):
        return (x.float() @ w.float().T).to(x.dtype).reshape(b, s, heads, -1)

    o = temporal_attention_ref(proj(wq), proj(wk), proj(wv), scale)
    out = o.reshape(b, s, c).float() @ wo.float().T + bo.float()
    return out.to(x.dtype)


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
    if lib.fyc_temporal_attention_smem_bytes(s, d) > _build.MAX_SMEM:
        raise ValueError(f"temporal_attention: S={s}, D={d} does not fit one "
                         "block's shared memory")
    out = torch.empty_like(query)
    with torch.cuda.device(query.device):
        err = lib.fyc_temporal_attention(
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            out.data_ptr(), b, s, h, d, float(scale),
            _build.DTYPE_CODES[query.dtype],
            torch.cuda.current_stream(query.device).cuda_stream)
    _build.check(err, "temporal_attention")
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0


@functools.lru_cache(maxsize=None)
def positions_per_block(f: int, c: int, dtype: torch.dtype) -> int:
    """Positions per block of :func:`fused_temporal_block` (0: no fit)."""
    lib = _build.load_library()
    code = _build.DTYPE_CODES[dtype]
    return _build.tile_positions(
        f, lambda g: lib.fyc_temporal_block_smem_bytes(g, f, c, code))


def fused_temporal_block(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                         scale: float | None = None,
                         heads: int = 8) -> torch.Tensor:
    """q/k/v projections → per-head frame attention → out-projection + bias
    over ``(B, S, C)`` rows; one read of x, one write."""
    b, s, c = x.shape
    if scale is None:
        scale = (c // heads) ** -0.5
    weights = (wq, wk, wv, wo, bo)
    if x.device.type == "cpu":
        return temporal_block_ref(x, *weights, scale=scale, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block: no kernel for {x.device}")
    _check_dtype_device("fused_temporal_block", (x,) + weights, x)
    for name, w in zip(("wq", "wk", "wv", "wo"), weights):
        if tuple(w.shape) != (c, c):
            raise ValueError(f"fused_temporal_block: {name} "
                             f"{tuple(w.shape)}, expected {(c, c)}")
    if tuple(bo.shape) != (c,):
        raise ValueError(f"fused_temporal_block: bo {tuple(bo.shape)}, "
                         f"expected {(c,)}")
    if c % heads or not 0 < s <= MAX_FRAMES or b == 0:
        raise ValueError(f"fused_temporal_block: (B, S, C) = {(b, s, c)} "
                         f"with {heads} heads; the kernel takes 1 ≤ S ≤ "
                         f"{MAX_FRAMES}, B ≥ 1 and C divisible by the heads")
    g = positions_per_block(s, c, x.dtype)
    if g == 0:
        raise ValueError(f"fused_temporal_block: S={s}, C={c}, {x.dtype} "
                         "does not fit one block's shared memory")
    lib = _build.load_library()
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 5)(*[w.data_ptr() for w in weights])
    with torch.cuda.device(x.device):
        err = lib.fyc_temporal_block(
            x.data_ptr(), ptrs, out.data_ptr(), b, s, c, heads, g,
            float(scale), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_temporal_block")
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0
