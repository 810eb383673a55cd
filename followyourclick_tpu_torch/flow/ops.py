"""Flow ops: coordinate grids, bilinear sampling, warping, the all-pairs
correlation pyramid and its lookup, resizing and convex upsampling.

Port of ``followyourclick_tpu/flow/ops.py`` (mmflow's ``ops/warp.py``,
``ops/corr_lookup.py`` and the mmcv ``Correlation`` operator), NCHW as
mmflow: a flow is ``(B, 2, H, W)`` with x (u) in channel 0, y (v) in 1.

As in the JAX package there is no kernel here. Level 0 of the pyramid is
one batched product (``torch.matmul``); the lookups are gathers over a
flattened map with each tap zeroed outside it on its own, which is
``grid_sample(padding_mode="zeros")`` written so that a 1x1 map (the
deepest level at small sizes) divides by ``max(size - 1, 1)``, never 0.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def coords_grid(batch: int, h: int, w: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Pixel coordinates ``(batch, 2, h, w)``: channel 0 holds x, 1 y."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xx, yy])[None].expand(batch, 2, h, w)


def gather_bilinear(feat: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Bilinear read of ``feat (B, C, H, W)`` at pixel coordinates ``x, y
    (B, *S)`` → ``(B, C, *S)``; each of the four taps outside the map reads
    0 (``grid_sample`` zero padding)."""
    B, C, H, W = feat.shape
    out_shape = x.shape[1:]
    x = x.reshape(B, 1, -1)
    y = y.reshape(B, 1, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(feat.dtype)
    wy = (y - y0).to(feat.dtype)
    flat = feat.reshape(B, C, H * W)

    def tap(xi, yi):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        vals = torch.gather(flat, 2, idx.expand(B, C, idx.shape[-1]))
        return vals * inside.to(feat.dtype)

    out = (tap(x0, y0) * (1 - wx) * (1 - wy)
           + tap(x0 + 1, y0) * wx * (1 - wy)
           + tap(x0, y0 + 1) * (1 - wx) * wy
           + tap(x0 + 1, y0 + 1) * wx * wy)
    return out.reshape(B, C, *out_shape)


def bilinear_sample(feat: torch.Tensor, grid: torch.Tensor,
                    align_corners: bool = False,
                    scale: bool = True) -> torch.Tensor:
    """Sample ``feat (B, C, H, W)`` at ``grid (B, *S, 2)`` (x, y last) →
    ``(B, C, *S)``. With ``scale`` the grid holds pixel coordinates and is
    first normalised as mmflow does (``x·2/max(W−1, 1) − 1``), then
    denormalised by ``grid_sample``'s rule for ``align_corners``."""
    H, W = feat.shape[2:]
    x, y = grid[..., 0], grid[..., 1]
    if scale:
        x = x * 2.0 / max(W - 1, 1) - 1.0
        y = y * 2.0 / max(H - 1, 1) - 1.0
    if align_corners:
        x = (x + 1.0) / 2.0 * (W - 1)
        y = (y + 1.0) / 2.0 * (H - 1)
    else:
        x = ((x + 1.0) * W - 1.0) / 2.0
        y = ((y + 1.0) * H - 1.0) / 2.0
    return gather_bilinear(feat, x, y)


def flow_warp(feat: torch.Tensor, flow: torch.Tensor,
              align_corners: bool = True,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Backward warp: ``out(p) = feat(p + flow(p))`` for ``feat (B, C, H,
    W)`` and ``flow (B, 2, H, W)``, zero or border padding (mmflow
    ``Warp``). A zero flow gives ``feat`` back."""
    B, _, H, W = flow.shape
    grid = coords_grid(B, H, W, flow.dtype, flow.device) + flow
    x, y = grid[:, 0], grid[:, 1]
    if not align_corners:
        x = ((x * 2.0 / max(W - 1, 1) - 1.0 + 1.0) * W - 1.0) / 2.0
        y = ((y * 2.0 / max(H - 1, 1) - 1.0 + 1.0) * H - 1.0) / 2.0
    if padding_mode == "border":
        x = x.clamp(0, W - 1)
        y = y.clamp(0, H - 1)
    return gather_bilinear(feat, x, y)


def correlation_pyramid(feat1: torch.Tensor, feat2: torch.Tensor,
                        num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation ``<feat1[p], feat2[q]> / sqrt(C)`` of ``(B, C,
    H, W)`` features as ``(B·H·W, 1, H_l, W_l)`` maps, one per level; each
    deeper level averages 2x2 target cells (odd rows and columns dropped)."""
    B, C, H, W = feat1.shape
    corr = torch.matmul(feat1.reshape(B, C, H * W).transpose(1, 2),
                        feat2.reshape(B, C, H * W)) / math.sqrt(C)
    pyramid = [corr.reshape(B * H * W, 1, H, W)]
    for _ in range(num_levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, 2))
    return pyramid


def corr_lookup(pyramid: Sequence[torch.Tensor], flow: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """For each pixel p and level l, the ``(2r+1)²`` window of level l read
    bilinearly (``align_corners=True``) around ``(p + flow(p)) / 2^l``, as
    ``(B, levels·(2r+1)², H, W)``. The window's slow axis offsets x and its
    fast axis y (mmflow stacks ``meshgrid(dy, dx)`` onto (x, y)), which
    fixes the channel order a converted checkpoint expects."""
    B, _, H, W = flow.shape
    centre = (coords_grid(B, H, W, flow.dtype, flow.device) + flow)
    centre = centre.permute(0, 2, 3, 1).reshape(B * H * W, 1, 2)
    d = torch.arange(-radius, radius + 1, dtype=flow.dtype,
                     device=flow.device)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([di, dj], dim=-1).reshape(1, -1, 2)
    out = []
    for lvl, cmap in enumerate(pyramid):
        coords = centre / (2.0 ** lvl) + delta
        vals = bilinear_sample(cmap, coords, align_corners=True)
        out.append(vals.reshape(B, H, W, -1))
    # NCHW in memory too: a channels-last input sends the motion encoder's
    # fp32 3x3 convs to cuDNN's FFT tiling, 20-40x slower on the H100
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def _linspace(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jnp.linspace(0, n_in - 1, n_out)``: ``iota · delta`` in fp32, the
    endpoint exact."""
    if n_out == 1:
        return torch.zeros(1, device=device)
    delta = torch.tensor(n_in - 1.0) / (n_out - 1)
    pos = torch.arange(n_out - 1, dtype=torch.float32) * delta
    return torch.cat([pos, torch.tensor([n_in - 1.0])]).to(device)


def bilinear_resize(x: torch.Tensor, H: int, W: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of ``(B, C, h, w)``. ``align_corners=False`` is
    ``jax.image.resize``: half-pixel centres and, when shrinking, a
    triangle filter widened by the scale (``antialias=True``);
    ``align_corners=True`` maps corners onto corners by a separable
    gather."""
    if not align_corners:
        return F.interpolate(x, size=(H, W), mode="bilinear",
                             align_corners=False, antialias=True)
    h, w = x.shape[2:]

    def axis(n_in, n_out):
        pos = _linspace(n_in, n_out, x.device)
        lo = torch.floor(pos).long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        return lo, hi, (pos - lo).to(x.dtype)

    y0, y1, wy = axis(h, H)
    x0, x1, wx = axis(w, W)
    rows = (x[:, :, y0] * (1.0 - wy)[:, None]
            + x[:, :, y1] * wy[:, None])
    return rows[..., x0] * (1.0 - wx) + rows[..., x1] * wx


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsampling of ``(B, 2, h, w)``, values scaled by 8."""
    h, w = flow.shape[2:]
    return 8.0 * bilinear_resize(flow, 8 * h, 8 * w, align_corners=True)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, scale: int = 8,
                    grid_side: int = 3) -> torch.Tensor:
    """RAFT's convex upsampling: each fine pixel a softmax-weighted
    combination of the ``grid_side²`` coarse neighbours (``F.unfold``'s
    row-major order). ``flow (B, 2, h, w)``, ``mask (B, 9·scale², h, w)``
    logits (channel ``k·scale² + u·scale + v``) → ``(B, 2, scale·h,
    scale·w)``."""
    B, _, h, w = flow.shape
    K = grid_side * grid_side
    mask = torch.softmax(mask.reshape(B, 1, K, scale, scale, h, w), dim=2)
    neigh = F.unfold(scale * flow, grid_side, padding=grid_side // 2)
    neigh = neigh.reshape(B, 2, K, 1, 1, h, w)
    up = (mask * neigh).sum(dim=2)                       # (B, 2, u, v, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, scale * h, scale * w)


def resize_flow(flow: torch.Tensor, shape: Tuple[int, int],
                align_corners: bool = False) -> torch.Tensor:
    """Resize ``(B, 2, h, w)`` to ``shape``, the displacements rescaled by
    the size ratio (mmflow ``BaseDecoder.get_flow``)."""
    h, w = flow.shape[2:]
    H, W = shape
    out = bilinear_resize(flow, H, W, align_corners=align_corners)
    ratio = torch.tensor([W / w, H / h], dtype=flow.dtype,
                         device=flow.device)
    return out * ratio[:, None, None]


def local_correlation(feat1: torch.Tensor, feat2: torch.Tensor,
                      max_displacement: int = 4, scaled: bool = False,
                      dilation_patch: int = 1,
                      stride: int = 1) -> torch.Tensor:
    """mmcv ``Correlation`` (kernel 1, padding 0): ``out[b, (dy, dx), h, w]
    = Σ_c f1[b, c, h, w] · f2[b, c, h + dy, w + dx]``, zero padded, over a
    ``(2d+1)²`` window at step ``dilation_patch`` in row-major order, output
    positions subsampled by ``stride``; divided by C when ``scaled``."""
    B, C, H, W = feat1.shape
    d = max_displacement
    p = d * dilation_patch
    padded = F.pad(feat2, (p, p, p, p))
    f1 = feat1[:, :, ::stride, ::stride]
    outs = []
    for dy in range(2 * d + 1):
        for dx in range(2 * d + 1):
            oy, ox = dy * dilation_patch, dx * dilation_patch
            shifted = padded[:, :, oy:oy + H:stride, ox:ox + W:stride]
            outs.append((f1 * shifted).sum(dim=1))
    corr = torch.stack(outs, dim=1)
    return corr / C if scaled else corr
