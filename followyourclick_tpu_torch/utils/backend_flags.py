"""The numerics every entry point of the port runs under.

The port is checked against the JAX package, whose fp32 is IEEE fp32 and
whose bf16 products accumulate in fp32, with three PyTorch flags off:

- ``torch.backends.cuda.matmul.allow_tf32`` (fp32 cuBLAS products in TF32);
- ``torch.backends.cudnn.allow_tf32`` (fp32 cuDNN convolutions in TF32,
  on by PyTorch's default);
- ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  (bf16 GEMMs reducing in bf16, on by PyTorch's default).

:func:`checked_precision` sets the three to False and gives the caller's
values back on exit, so an entry point runs under the flags its card
checks were read with, whatever the process had set. It works as a
``with`` block and as a decorator.
"""

from __future__ import annotations

import contextlib

import torch

_FLAGS = (
    (torch.backends.cuda.matmul, "allow_tf32"),
    (torch.backends.cudnn, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"),
)


def precision_flags() -> tuple:
    """The three flags' current values, in the order of ``_FLAGS``."""
    return tuple(getattr(owner, name) for owner, name in _FLAGS)


def _set(values) -> None:
    for (owner, name), value in zip(_FLAGS, values):
        setattr(owner, name, value)


@contextlib.contextmanager
def checked_precision():
    """TF32 and bf16 reduced-precision reduction off inside the block; the
    caller's values restored on exit, also on an exception."""
    saved = precision_flags()
    _set((False,) * len(_FLAGS))
    try:
        yield
    finally:
        _set(saved)
