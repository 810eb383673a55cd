"""Device ms per training step in the program's span
``fyc.train.forward`` (the UNet forward and the loss of
``train_step_partitioned``), over the steps of the traced detail part."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.train.forward", "step")
