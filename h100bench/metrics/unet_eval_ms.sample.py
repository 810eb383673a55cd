"""Device ms per UNet evaluation: every kernel launched inside the
benchmark's range around each call into the pipeline's UNet
(``models/unet3d.py``), the kernels' own ranges nested in it included,
summed and divided by the calls."""

from h100bench.harness import trace as tr


def ranges(program):
    if "pipe" not in program:
        return {}
    return {"unet": lambda: tr.method_ranged(program["pipe"].unet, "forward",
                                             "unet")}


def read(rec):
    us, calls = rec.inclusive("unet")
    if not calls:
        return None
    return us / 1e3 / calls
