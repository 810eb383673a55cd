"""Pyramid-Attention-Broadcast-style reuse of attention and trunk outputs.

Port of ``followyourclick_tpu/models/pab.py``: an opt-in serving
approximation, not reference behaviour. Every attention sublayer (and the
UNet trunk, for DeepCache-style reuse) is wrapped in :func:`pab_site`. A
``PabMode`` that records writes the sublayer's output into the cache; one
that reuses returns the cached output and skips the whole sublayer (pre-LN,
q/k/v, attention, out-projection). ``pab=None`` is the exact path.

The sites, in the order a UNet evaluation meets them in each block: a
spatial transformer block's ``attn1_out`` (kind ``spatial``), ``attn2_out``
and, with T5, ``attn_t5_out`` (``cross``), and with in-block temporal
attention ``attn_temp_out`` (``temporal``); a motion block's ``attn_0_out``
and ``attn_1_out`` (``temporal``); the trunk's ``deep_trunk`` (``deep``).

The cache is a plain ``dict[str, Tensor]`` that the sampler owns and passes
down through ``forward``; a site updates it in place. A key is the site's
module path in the UNet (``torch`` qualified name, set by
:func:`name_sites`) and the site name, joined by a dot, e.g.
``down_blocks.0.attentions.0.transformer_blocks.0.attn1_out``; the trunk's is
``deep_trunk`` (and ``deep_trunk_prev``, ``deep_trunk_valid`` under the
forecast). Under the ``_flax_path`` rule of ``utils/convert.py`` each key is
the JAX ``"pab"`` collection path of the same site.

What the JAX package needs and the port does not: its sampler threads the
cache as a ``lax.scan`` carry, so every step variant must return the same
tree. It merges a step's mutated collection over the carried one
(``_merge_cache``) and writes a reused value back on reuse steps. A dict
keeps the entries a step did not touch by itself, so neither is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class PabMode:
    """Static per-step reuse / record flags (the JAX ``PabMode``).

    ``reuse_*`` returns the cached output instead of computing it;
    ``record_*`` stores a freshly computed output. ``deep_extrapolate`` keeps
    the last two trunk records and returns ``cur + deep_ex_coeff·(cur −
    prev)`` on reuse steps. ``half``: the UNet runs on the cond half of the
    CFG batch against a cache recorded at the full batch.
    """

    reuse_spatial: bool = False
    reuse_cross: bool = False
    reuse_temporal: bool = False
    record_spatial: bool = False
    record_cross: bool = False
    record_temporal: bool = False
    reuse_deep: bool = False
    record_deep: bool = False
    deep_extrapolate: bool = False
    deep_ex_coeff: float = 0.0
    half: bool = False

    def reuse(self, kind: str) -> bool:
        return getattr(self, f"reuse_{kind}")

    def record(self, kind: str) -> bool:
        return getattr(self, f"record_{kind}")


def name_sites(root: nn.Module) -> nn.Module:
    """Give every submodule of ``root`` its qualified name as the prefix of
    its cache keys."""
    for name, module in root.named_modules():
        module.pab_path = name
    return root


def pab_site(module: nn.Module, kind: str, name: str,
             pab: Optional[PabMode], cache: Optional[dict],
             compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """One sublayer: compute (and record), or return the cached output.

    ``kind`` is ``spatial``, ``cross``, ``temporal`` or ``deep``. The cached
    value is the sublayer's whole output (after the out-projection, before
    the residual add)."""
    if pab is None:
        return compute()
    if cache is None:
        raise ValueError("pab_site: a PabMode needs a cache dict")
    prefix = getattr(module, "pab_path", "")
    key = f"{prefix}.{name}" if prefix else name
    if kind == "deep" and pab.deep_extrapolate:
        return _deep_ex_site(key, pab, cache, compute)
    if pab.half:
        if not (pab.reuse(kind) or pab.record(kind)):
            return compute()  # this kind is not in the schedule
        if key not in cache:
            raise RuntimeError(f"pab_site {key}: a half-batch step needs a "
                               "cache recorded by a full step")
        cached = cache[key]
        n2 = cached.shape[0] // 2
        if pab.reuse(kind):
            return cached[n2:]
        out = compute()
        if pab.record(kind):
            cache[key] = torch.cat([cached[:n2], out], dim=0)
        return out
    if pab.reuse(kind) and key in cache:
        return cache[key]
    out = compute()
    if pab.record(kind):
        cache[key] = out
    return out


def _deep_ex_site(key: str, pab: PabMode, cache: dict,
                  compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The trunk site with the first-order forecast.

    Entries: ``key`` (the last recorded trunk), ``key_prev`` (the record
    before it) and ``key_valid`` (0-d fp32: 1 once a record exists, so the
    first record sets prev = cur and the first period reuses with slope 0).
    Reuse steps never write: the forecast must not become the slope's base.
    """
    pkey, vkey = key + "_prev", key + "_valid"
    has = key in cache
    if pab.reuse("deep") and has:
        cur, prev = cache[key], cache[pkey]
        c32 = cur.float()
        out = (c32 + pab.deep_ex_coeff * (c32 - prev.float())).to(cur.dtype)
        return out[cur.shape[0] // 2:] if pab.half else out
    out = compute()
    if pab.record("deep"):
        if pab.half:
            # cond-half refresh against a full-batch cache: the uncond half
            # keeps its last full-step value in cur and prev (slope 0)
            if not has:
                raise RuntimeError(f"pab_site {key}: a half-batch trunk "
                                   "refresh needs a cache recorded by a full "
                                   "step")
            cur = cache[key]
            new_cur = torch.cat([cur[:cur.shape[0] // 2], out], dim=0)
        else:
            cur = cache[key] if has else out
            new_cur = out
        valid = cache.get(vkey)
        if valid is None:
            valid = torch.zeros((), dtype=torch.float32, device=out.device)
        cache[pkey] = torch.where(valid > 0, cur, new_cur)
        cache[key] = new_cur
        cache[vkey] = torch.ones((), dtype=torch.float32, device=out.device)
    return out
