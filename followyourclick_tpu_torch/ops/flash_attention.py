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

Under autograd (an input that requires grad) a call goes through
:class:`FlashAttentionGrad`: it saves q, k and v, and its backward is the
JAX ``_flash_vjp_bwd`` math, an fp32 recompute of the scores and the softmax
Jacobian, run over ``B·H`` in the plain version's chunks so that no more
than ``REF_CHUNK_BYTES`` of fp32 scores exist at once (the rows are
independent, so the result is the unchunked one).
"""

from __future__ import annotations

import functools

import torch

from followyourclick_tpu_torch.ops import _build
from followyourclick_tpu_torch.ops.autograd import needs_grad

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


def _fold(t: torch.Tensor) -> torch.Tensor:
    """``(B, S, H, D)`` → ``(B·H, S, D)``."""
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d)


class FlashAttentionGrad(torch.autograd.Function):
    """:func:`flash_attention` under autograd."""

    @staticmethod
    def forward(ctx, run, scale, query, key, value):
        ctx.scale = scale
        ctx.save_for_backward(query, key, value)
        return run(query, key, value)

    @staticmethod
    def backward(ctx, grad):
        query, key, value = ctx.saved_tensors
        b, sq, h, d = query.shape
        sk = key.shape[1]
        q, k, v, g = (_fold(t) for t in (query, key, value, grad))
        dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32,
                                  device=t.device) for t in (q, k, v))
        step = max(1, REF_CHUNK_BYTES // (sq * sk * 4))
        for i in range(0, b * h, step):
            rows = slice(i, i + step)
            qi, ki, vi, gi = (t[rows].float() for t in (q, k, v, g))
            p = torch.softmax(torch.bmm(qi, ki.transpose(1, 2)) * ctx.scale,
                              -1)
            dv[rows] = torch.bmm(p.transpose(1, 2), gi)
            dp = torch.bmm(gi, vi.transpose(1, 2))
            ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * ctx.scale
            dq[rows] = torch.bmm(ds, ki)
            dk[rows] = torch.bmm(ds.transpose(1, 2), qi)

        def unfold(t, like):
            return t.reshape(b, h, -1, d).transpose(1, 2).to(like.dtype)

        return (None, None, unfold(dq, query), unfold(dk, key),
                unfold(dv, value))


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
    run = functools.partial(_flash_attention, scale=scale)
    if needs_grad(query, key, value):
        return FlashAttentionGrad.apply(run, scale, query, key, value)
    return run(query, key, value)


def _flash_attention(query, key, value, *, scale):
    """The route: the plain version on a CPU tensor, else the kernel."""
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
