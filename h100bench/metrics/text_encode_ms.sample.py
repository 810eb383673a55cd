"""Device ms per request in the program's span ``fyc.encode_prompt``
(``AnimationPipeline.encode_prompt``: the CLIP text encoder over the
prompt and the negative prompt), over the traced requests."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.encode_prompt", "request")
