"""The LN → GEGLU → residual kernel's share of its roofline, read from the
program's spans ``fyc.kernel.fused_ln_geglu:<R>x<C>``
(``ops/geglu.fused_ln_geglu``): Σ bound / Σ device time, in percent, with
``ln_geglu_roofline.sample``'s bound."""

from h100bench.harness import spans
from h100bench.harness.metrics import load

ranges = spans.ranges


def read(rec):
    return spans.roofline(rec, "fyc.kernel.fused_ln_geglu:",
                          load("ln_geglu_roofline.sample").bound_s)
