"""Device ms per decoded clip: the kernels launched inside the benchmark's
range around the pipeline's ``vae.decode`` (``models/vae.py``, reached
through ``decode_latents``), over the clips the traced requests decoded."""

from h100bench.harness import trace as tr


def ranges(program):
    if "pipe" not in program:
        return {}
    return {"vae_decode": lambda: tr.method_ranged(program["pipe"].vae,
                                                   "decode", "vae_decode")}


def read(rec):
    us, calls = rec.inclusive("vae_decode")
    clips = sum(w.get("clips", 0) for w in rec.detail_work)
    if not calls or not clips:
        return None
    return us / 1e3 / clips
