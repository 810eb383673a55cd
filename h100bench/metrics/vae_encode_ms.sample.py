"""Device ms per request in the program's span ``fyc.encode_image``
(``AnimationPipeline.encode_image``: the VAE encoder over the first
frame), over the traced requests."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.encode_image", "request")
