"""Online-softmax tiled attention in one hand-written kernel.

Port of ``followyourclick_tpu/ops/flash_attention.py::flash_attention`` (the
Pallas kernel ``_fwd_kernel``): attention over ``(B, S, H, D)`` tensors whose
full score set is too large to keep, the route of
``ops/attention.dot_product_attention`` above 12 GiB of bf16 scores (level-0
spatial self-attention of a 2-clip CFG request at 16 frames, 512²).

On a CUDA tensor :func:`flash_attention` launches the ``sm_90a`` kernel of
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version :func:`flash_attention_ref`. The kernel reads q, k and v by
stride from the ``(B, S, H, D)`` layout; the Pallas wrapper's transpose to
``(B·H, S, D)`` and its pad of D to 128 lanes are not carried over.

Numerics (as the Pallas kernel): logits ``q·kᵀ`` in fp32 times ``scale``, the
softmax statistics (row max, ``p = exp(s − m)``, ``l = Σp``) in fp32, p cast
to v's dtype before ``p·v``, which accumulates in fp32, then divided by
``l`` and cast. The kernel's running max differs from the plain version's
global one only by where p is rounded.

Forward only: the JAX backward ``_flash_vjp_bwd`` is a plain recompute for
training, which the port has not reached yet.
"""

from __future__ import annotations

import torch

from followyourclick_tpu_torch.ops import _build

MAX_HEAD_DIM = 160
MAX_BATCH_HEADS = 65535  # the grid's y extent, one row per batch·head
# the plain version's fp32 score chunk (B·H rows at a time), about 2 GiB
REF_CHUNK_BYTES = 2 * 1024 ** 3


def flash_attention_ref(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``(B, Sq, H, D)`` q and
    ``(B, Sk, H, D)`` k, v in; ``(B, Sq, H, D)`` out in q's dtype. Runs
    ``B·H`` in chunks whose fp32 scores take at most ``REF_CHUNK_BYTES``."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    if scale is None:
        scale = d ** -0.5
    q = query.transpose(1, 2).reshape(b * h, sq, d)
    k = key.transpose(1, 2).reshape(b * h, sk, d)
    v = value.transpose(1, 2).reshape(b * h, sk, d)
    out = torch.empty(b * h, sq, d, dtype=query.dtype, device=query.device)
    step = max(1, REF_CHUNK_BYTES // (sq * sk * 4))
    for i in range(0, b * h, step):
        s = torch.bmm(q[i:i + step].float(),
                      k[i:i + step].float().transpose(1, 2)).mul_(scale)
        s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
        l_sum = s.sum(dim=-1, keepdim=True)
        o = torch.bmm(s.to(value.dtype).float(), v[i:i + step].float())
        out[i:i + step] = (o / l_sum).to(query.dtype)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def _check_args(query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> None:
    """Raise on what the kernel does not take: another device or dtype
    than q's, dtypes other than fp32 and bf16, non-contiguous tensors,
    shapes other than (B, Sq, H, D) and (B, Sk, H, D) with one (B, H, D),
    D not a multiple of 8 up to ``MAX_HEAD_DIM``, data not 16-byte aligned,
    ``B·H`` above ``MAX_BATCH_HEADS``."""
    if query.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {query.dtype} not supported")
    for t in (query, key, value):
        if t.device != query.device or t.dtype != query.dtype:
            raise ValueError("flash_attention: q, k, v must share q's "
                             f"device and dtype ({query.device}, "
                             f"{query.dtype})")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous "
                             "(B, S, H, D) tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: data must be 16-byte aligned")
    b, sq, h, d = query.shape
    if key.shape != value.shape or key.shape[0] != b \
            or key.shape[2:] != query.shape[2:]:
        raise ValueError("flash_attention: q (B, Sq, H, D) and k, v "
                         f"(B, Sk, H, D) disagree: {tuple(query.shape)}, "
                         f"{tuple(key.shape)}, {tuple(value.shape)}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: D={d}; the kernel takes a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if min(b, sq, h, key.shape[1]) == 0:
        raise ValueError("flash_attention: empty input")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B·H = {b * h}; the kernel's grid "
                         f"takes at most {MAX_BATCH_HEADS}")


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention of ``(B, Sq, H, D)`` q over ``(B, Sk, H, D)`` k, v
    without keeping the ``(Sq, Sk)`` scores."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    if query.device.type == "cpu":
        return flash_attention_ref(query, key, value, scale)
    if query.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {query.device}")
    _check_args(query, key, value)
    b, sq, h, d = query.shape
    lib = _build.load_library()
    out = torch.empty_like(query)
    with torch.cuda.device(query.device):
        err = lib.fyc_flash_attention(
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            out.data_ptr(), b, sq, key.shape[1], h, d, float(scale),
            _build.DTYPE_CODES[query.dtype],
            torch.cuda.current_stream(query.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
