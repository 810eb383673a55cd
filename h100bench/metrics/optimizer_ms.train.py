"""Device ms per training step in the program's span
``fyc.train.optimizer`` (``state.tx.update``: the global-norm clip and
``MaskedAdamW``'s per-leaf update), over the steps of the traced detail
part."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.train.optimizer", "step")
