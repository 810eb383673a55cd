"""Device ms per training step in the program's span
``fyc.train.backward`` (the step's ``torch.autograd.grad``: the
checkpoint's second forward and the kernels' fp32 recompute inside it),
over the steps of the traced detail part; the autograd engine's device
thread launches these kernels while the span waits."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.train.backward", "step")
