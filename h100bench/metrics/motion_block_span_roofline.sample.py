"""The whole-block motion kernel's share of its roofline, read from the
program's spans ``fyc.kernel.fused_motion_block:<P>x<F>x<C>x<heads>``
(``ops/motion_block.fused_motion_block``): Σ bound / Σ device time, in
percent, with ``motion_block_roofline.sample``'s bound."""

from h100bench.harness import spans
from h100bench.harness.metrics import load

_bound_s = load("motion_block_roofline.sample").bound_s

ranges = spans.ranges


def read(rec):
    return spans.roofline(rec, "fyc.kernel.fused_motion_block:",
                          lambda p, f, c, heads: _bound_s(p, f, c))
