"""The GroupNorm kernel's share of its roofline, read from the program's
spans ``fyc.kernel.fused_group_norm:<B>x<N>x<C>x<element bytes>``
(``ops/groupnorm.fused_group_norm``, on the kernel path only): Σ bound /
Σ device time, in percent. The bound is the work whatever implements it:
x read once and y written once (B·N·C elements each), the scale and the
bias read once (C each), at 3.35 TB/s; GroupNorm's few operations an
element never bind."""

from h100bench.harness import spans
from h100bench.harness.device import HBM_BYTES_PER_S

PREFIX = "fyc.kernel.fused_group_norm:"

ranges = spans.ranges


def bound_s(b, n, c, esize):
    return (2 * b * n * c + 2 * c) * esize / HBM_BYTES_PER_S


def read(rec):
    return spans.roofline(rec, PREFIX, bound_s)
