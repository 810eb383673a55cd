"""Device ms per decoded clip in the program's span ``fyc.decode``
(``AnimationPipeline.decode_latents``: the VAE decoder and the scaling
around it), over the clips the traced requests decoded:
``vae_decode_ms.sample`` read from inside."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per(rec, "fyc.decode", "request", "clips")
