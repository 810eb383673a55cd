"""Device ms per training step in the program's span ``fyc.train.encode``
(``training/step.encode_batch``: the VAE encoder over the batch's clips),
over the steps of the traced detail part."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.train.encode", "step")
