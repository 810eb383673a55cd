"""GroupNorm (+SiLU) over ``(B, N, C)`` rows, one hand-written kernel.

Port of ``followyourclick_tpu/ops/groupnorm.py::fused_group_norm``. On a
CUDA tensor :func:`fused_group_norm` launches the ``sm_90a`` kernel of
``csrc/groupnorm.cu`` (a statistics pass and an apply pass over chunks of N,
so any N fits) or raises; on a CPU tensor it runs :func:`group_norm_ref`,
the plain PyTorch version with the kernel's numerics.

Numerics are the Pallas kernel's (``_kernel``), not those of
``models/layers.GroupNorm``: the statistics are shifted by a pilot, the
mean of each group's channels at row 0 (the module takes the group's first
element), and summed in fp32; ``var = max(s2/n − (s1/n)², 0)``; the affine
is folded into ``y = x·a + b`` in fp32; SiLU follows it; then the cast.

Not routed, as in the JAX package (``models/layers.py:137-141``): the port's
``GroupNorm`` module keeps its plain path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build

VEC = 8            # channels per vector of the kernel
MAX_CHANNELS = 16384  # the statistics pass keeps 2·C fp32 sums per block
TARGET_BLOCKS = 264  # two blocks per SM of the H100 per pass


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32, eps: float = 1e-5,
                   act: str | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel over ``(B, N, C)`` rows."""
    b, n, c = x.shape
    cg = c // groups
    xf = x.float()
    pilot_g = xf[:, 0, :].reshape(b, groups, cg).mean(-1)          # (B, G)
    shifted = xf - pilot_g.repeat_interleave(cg, dim=1)[:, None, :]
    s1 = shifted.sum(1).reshape(b, groups, cg).sum(-1)
    s2 = (shifted * shifted).sum(1).reshape(b, groups, cg).sum(-1)
    cnt = n * cg
    mean_c = s1 / cnt
    var = torch.clamp(s2 / cnt - mean_c * mean_c, min=0.0)
    inv = torch.rsqrt(var + eps).repeat_interleave(cg, dim=1)       # (B, C)
    mean = (mean_c + pilot_g).repeat_interleave(cg, dim=1)
    a = inv * scale.float()
    shift = bias.float() - mean * a
    y = xf * a[:, None, :] + shift[:, None, :]
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def chunk_rows(b: int, n: int) -> int:
    """Rows of N per block: about ``TARGET_BLOCKS`` blocks over the grid of
    (chunk, batch row), at least 32 rows a chunk."""
    chunks = max(1, min(math.ceil(n / 32), TARGET_BLOCKS // max(b, 1)))
    return math.ceil(n / chunks)


def _check(x, scale, bias, groups) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_group_norm: dtype {x.dtype} not supported")
    if x.ndim != 3:
        raise ValueError(f"fused_group_norm: x must be (B, N, C), got "
                         f"{tuple(x.shape)}")
    b, n, c = x.shape
    if min(b, n, c) == 0 or b > 65535 or b * n * c >= 2 ** 62:
        raise ValueError(f"fused_group_norm: unsupported shape "
                         f"{tuple(x.shape)}")
    if c % VEC or c > MAX_CHANNELS or c % groups:
        raise ValueError(f"fused_group_norm: C={c}, groups={groups}; the "
                         f"kernel takes C a multiple of {VEC} up to "
                         f"{MAX_CHANNELS}, divided by the groups")
    for t, shape in ((scale, (c,)), (bias, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_group_norm: scale and bias must be "
                             f"({c},), got {tuple(t.shape)}")
    for t in (x, scale, bias):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("fused_group_norm: all tensors must share x's "
                             f"device and dtype ({x.device}, {x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_group_norm: tensors must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("fused_group_norm: x must be 16-byte aligned")


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                     act: str | None = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of ``(B, N, C)`` rows (spatial flattened to N),
    statistics per (batch row, group) over N and the group's channels."""
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: act={act!r}")
    if x.device.type == "cpu":
        return group_norm_ref(x, scale, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: no kernel for {x.device}")
    _check(x, scale, bias, groups)
    b, n, c = x.shape
    rows = chunk_rows(b, n)
    chunks = math.ceil(n / rows)
    lib = _build.load_library()
    out = torch.empty_like(x)
    ws = torch.empty(b * chunks * groups * 2, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fyc_group_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ws.data_ptr(),
            out.data_ptr(), b, n, c, groups, rows, float(eps),
            int(act == "silu"), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_group_norm")
    fused_group_norm.launches += 1
    return out


fused_group_norm.launches = 0
