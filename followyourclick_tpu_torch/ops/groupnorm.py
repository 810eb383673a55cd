"""GroupNorm (+SiLU) over ``(B, N, C)`` rows, hand-written kernels.

Port of ``followyourclick_tpu/ops/groupnorm.py::fused_group_norm``. On a
CUDA tensor :func:`fused_group_norm` launches the ``sm_90a`` kernels of
``csrc/groupnorm.cu`` or raises; on a CPU tensor it runs
:func:`group_norm_ref`, the plain PyTorch version with the kernel's
numerics. :func:`group_norm_path` chooses between two paths from (B, N, C,
dtype) alone, before any launch:

- ``"cluster"``: one launch; a thread-block cluster of up to 16 blocks owns
  a batch row and holds it in shared memory, so x is read once
  (:func:`launch_cluster`);
- ``"two_pass"``: a statistics pass and an apply pass over chunks of N, for
  slabs larger than the cluster can hold (:func:`launch_two_pass`).

A launch the card refuses raises; it never takes the other path.

Numerics are the Pallas kernel's (``_kernel``), not those of
``models/layers.GroupNorm``: the statistics are shifted by a pilot, the
mean of each group's channels at row 0 (the module takes the group's first
element), and summed in fp32; ``var = max(s2/n − (s1/n)², 0)``; the affine
is folded into ``y = x·a + b`` in fp32; SiLU follows it; then the cast.

Not routed, as in the JAX package (``models/layers.py:137-141``): the port's
``GroupNorm`` module keeps its plain path. Under autograd the call goes
through :class:`GroupNormGrad` (``ops/autograd.Recompute``): the kernel
forward, and the gradients of :func:`group_norm_fp32`, as the JAX
``_gn_bwd`` takes them.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.autograd import Recompute, needs_grad

VEC = 8            # channels per vector of the kernel
MAX_CHANNELS = 8192  # a block's scratch, (2·row_groups + 3)·C fp32 words
SMS = 132  # the H100's SMs: the two-pass grid aims at 2 blocks each
MAX_CLUSTER = 16   # blocks of a cluster (above 8: a non-portable size)
STATS_CLUSTER = 8  # stats blocks that pool their partials (two-pass)
# blocks a cluster-path call spreads over where N has the rows (a sweep of
# cluster sizes at the per-frame sites measured the fewest blocks that hold
# a row fastest, down to about this many blocks a call; PERF.md §6)
SPREAD = 64
MIN_CHUNK = 32 * 1024  # bytes of x a two-pass block takes at least
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


def row_groups(c: int) -> int:
    """Rows a block's threads take at once (``gn_row_groups`` of the
    kernel): about 256 threads over the ``C / 8`` vectors of a row."""
    cv = c // VEC
    return max(1, (256 + cv // 2) // cv)


def cluster_smem(rows: int, c: int, dtype: torch.dtype) -> int:
    """Shared memory of a cluster block holding ``rows`` rows of ``C``
    (``gn_cluster_smem``): the rows, the per-thread partials of every
    channel, three words per group (at most ``C`` groups) and the folded
    affine of every channel."""
    return rows * c * _ESIZE[dtype] + (2 * row_groups(c) + 5) * c * 4


@functools.lru_cache(maxsize=None)
def group_norm_path(b: int, n: int, c: int,
                    dtype: torch.dtype) -> tuple[str, int, int]:
    """The path of a ``(B, N, C)`` call: ``("cluster", blocks per cluster,
    rows per block)`` where a batch row fits the shared memory of at most
    ``MAX_CLUSTER`` blocks, else ``("two_pass", chunks per batch row, rows
    per chunk)``. The cluster is the smallest power of two whose blocks
    fit (fewer, fuller blocks measured faster), widened until the call
    spans ``SPREAD`` blocks where N has the rows; the two-pass grid aims at
    one wave of two blocks an SM (``2 · SMS``), in whole stats clusters of
    chunks of at least ``MIN_CHUNK`` bytes."""
    fits = [cs for cs in (1, 2, 4, 8, 16)
            if cluster_smem(math.ceil(n / cs), c, dtype) <= _build.MAX_SMEM]
    if fits:
        cs = fits[0]
        while cs < MAX_CLUSTER and cs * b < SPREAD and 2 * cs <= n:
            cs *= 2
        return "cluster", cs, math.ceil(n / cs)
    min_rows = math.ceil(MIN_CHUNK / (c * _ESIZE[dtype]))
    target = max(STATS_CLUSTER, 2 * SMS // b // STATS_CLUSTER * STATS_CLUSTER)
    rows = math.ceil(n / min(target, math.ceil(n / min_rows)))
    return "two_pass", two_pass_chunks(n, rows), rows


def two_pass_chunks(n: int, rows: int) -> int:
    """Chunks of the two-pass grid for ``rows`` rows a chunk
    (``gn_chunks``): ``ceil(N / rows)`` in whole stats clusters."""
    return math.ceil(math.ceil(n / rows) / STATS_CLUSTER) * STATS_CLUSTER


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


def group_norm_fp32(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                    act: str | None = None) -> torch.Tensor:
    """GroupNorm(+SiLU) in fp32 with the plain statistics (JAX
    ``_ref_fp32``), the reference of the backward."""
    b, n, c = x.shape
    xf = x.float().reshape(b, n, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, n, c)
    y = y * scale.float() + bias.float()
    return F.silu(y) if act == "silu" else y


class GroupNormGrad(Recompute):
    """:func:`fused_group_norm` under autograd."""


def _check(x, scale, bias, groups) -> None:
    """Raise on what the kernels do not take."""
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
    for t in (scale, bias):
        if t.ndim != 1 or t.shape[0] != c:
            raise ValueError(f"fused_group_norm: scale and bias must be "
                             f"({c},), got {tuple(t.shape)}")
    dev = x.get_device()
    for t in (x, scale, bias):
        if t.get_device() != dev or t.dtype != x.dtype:
            raise ValueError("fused_group_norm: all tensors must share x's "
                             f"device and dtype ({x.device}, {x.dtype})")
        if not t.is_contiguous():
            raise ValueError("fused_group_norm: tensors must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("fused_group_norm: x must be 16-byte aligned")


def launch_cluster(x, scale, bias, groups, eps, act, cs, rows, out) -> None:
    """The cluster path, one launch: ``cs`` blocks per batch row, each
    holding ``rows`` rows of N."""
    b, n, c = x.shape
    _build.check(_build.load_library().fyc_group_norm_cluster(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n,
        c, groups, cs, rows, float(eps), int(act == "silu"),
        _build.DTYPE_CODES[x.dtype], _build.stream(x)),
        f"fused_group_norm (cluster of {cs})")


def launch_two_pass(x, scale, bias, groups, eps, act, rows, out) -> None:
    """The two-pass path over chunks of ``rows`` rows of N, with its fp32
    workspace of one (s1, s2) pair per group and stats cluster."""
    b, n, c = x.shape
    pairs = b * two_pass_chunks(n, rows) // STATS_CLUSTER * groups
    ws = torch.empty(2 * pairs, dtype=torch.float32, device=x.device)
    _build.check(_build.load_library().fyc_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, n, c, groups, rows, float(eps), int(act == "silu"),
        _build.DTYPE_CODES[x.dtype], _build.stream(x)),
        "fused_group_norm (two passes)")


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                     act: str | None = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of ``(B, N, C)`` rows (spatial flattened to N),
    statistics per (batch row, group) over N and the group's channels."""
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: act={act!r}")
    args = (x, scale, bias)
    kw = dict(groups=groups, eps=eps, act=act)
    run = functools.partial(_group_norm, **kw)
    if needs_grad(*args):
        return GroupNormGrad.apply(
            run, functools.partial(group_norm_fp32, **kw), *args)
    return run(*args)


def _group_norm(x, scale, bias, *, groups, eps, act):
    """The route: the plain version on a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return group_norm_ref(x, scale, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: no kernel for {x.device}")
    _check(x, scale, bias, groups)
    path, count, rows = group_norm_path(*x.shape, x.dtype)
    out = torch.empty_like(x)
    with _build.on_device(x):
        if path == "cluster":
            launch_cluster(x, scale, bias, groups, eps, act, count, rows, out)
        else:
            launch_two_pass(x, scale, bias, groups, eps, act, rows, out)
    fused_group_norm.launches += 1
    return out


fused_group_norm.launches = 0
